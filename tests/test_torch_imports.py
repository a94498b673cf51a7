"""Import guard and device rule of the PyTorch port.

The port (``deeplearning4j_tpu_torch/``, ``chip_smoke.py``,
``int8_probe.py`` and ``guard_probe.py``) must import neither ``jax`` nor anything of
``deeplearning4j_tpu``, the package must call no library kernel in place
of its own (``chip_smoke.py`` times those as yardsticks only), and its
entry points must raise — not quietly run on the CPU — when CUDA is
asked for (explicitly or by default) and absent.
"""

import ast
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "deeplearning4j_tpu_torch"


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                         ROOT / "int8_probe.py",
                                         ROOT / "guard_probe.py"]


def _forbidden(name: str) -> bool:
    # ml_dtypes too: the card's machine has none, and the port's wire
    # format maps numpy dtype names to torch without it
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "deeplearning4j_tpu", "ml_dtypes")


def test_port_imports_no_jax_and_no_jax_package():
    files = _port_files()
    assert len(files) > 10 and (ROOT / "chip_smoke.py").exists()
    mods = {p.relative_to(PORT).as_posix() for p in files
            if p.is_relative_to(PORT)}
    assert {"observability/core.py", "observability/tracing.py",
            "observability/flightrec.py", "observability/goodput.py",
            "observability/device.py", "resilience/faults.py",
            "resilience/supervisor.py", "parallel/mesh.py",
            "parallel/zero.py", "parallel/checkpoint.py",
            "parallel/trainer.py", "parallel/collectives.py",
            "parallel/compile_cache.py", "parallel/observe.py",
            "parallel/__init__.py", "datasets/dataset.py",
            "datasets/iterator.py", "datasets/fetchers.py",
            "datasets/mnist_idx.py", "ops/dtypes.py", "ops/rng.py",
            "ops/sampling.py", "ops/activations.py", "ops/linalg.py",
            "ops/losses.py", "ops/convolution.py", "nn/conf.py",
            "nn/weights.py", "nn/layers.py", "nn/multilayer.py",
            "optimize/transforms.py", "optimize/api.py",
            "optimize/solvers.py", "evaluation/evaluation.py",
            "models/zoo.py", "utils/autodiff.py", "__main__.py",
            "observability/cost.py", "observability/kernels.py",
            "observability/timeseries.py", "observability/slo.py",
            "observability/fleet.py", "observability/server.py",
            "serving/router/ring.py", "serving/router/replicas.py",
            "serving/router/router.py", "serving/router/server.py",
            "serving/router/procserver.py", "control/overload.py",
            "control/autoscaler.py", "serving/disagg/migrate.py",
            "serving/disagg/scheduler.py", "online/capture.py",
            "online/loop.py", "ops/cuda/kv_quant.py",
            "ops/cuda/registry.py", "native/__init__.py", "native/build.py",
            "native/runtime.py", "datasets/svmlight.py",
            "datasets/records.py", "models/lstm.py", "models/resnet.py",
            *(f"text/{m}.py" for m in (
                "__init__", "tokenization", "sentence", "vocab",
                "similarity", "word2vec", "glove", "serializer",
                "paragraph_vectors", "vectorizers", "lm_dataset", "windows",
                "index", "tree", "treeparser", "annotator", "sentiwordnet")),
            "models/rntn.py", "utils/viterbi.py", "utils/counters.py",
            "utils/misc.py", "utils/stringgrid.py",
            *(f"clustering/{m}.py" for m in (
                "__init__", "kdtree", "kmeans", "quadtree", "vptree")),
            *(f"plot/{m}.py" for m in (
                "__init__", "tsne", "render_app", "renderers")),
            *(f"parallel/{m}.py" for m in (
                "scaleout", "procstate", "procrunner", "worker_main",
                "performers", "storage", "provision", "driver")),
            "text/scaleout_embeddings.py",
            *(f"tools/{m}.py" for m in (
                "__init__", "serving_smoke", "chaos_smoke", "ranks")),
            *(f"analysis/{m}.py" for m in (
                "__init__", "__main__", "runtime", "lockguard", "shardguard",
                "core", "baseline", "report", "engine", "jitinfo",
                "concurrency", "sharding", "rules"))} <= mods
    bad = []
    for path in files:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            elif isinstance(node, ast.Call) and getattr(
                    node.func, "attr", getattr(node.func, "id", "")) in (
                        "import_module", "__import__") and node.args \
                    and isinstance(node.args[0], ast.Constant):
                names = [str(node.args[0].value)]
            else:
                continue
            bad += [f"{path.relative_to(ROOT)}:{node.lineno} {n}"
                    for n in names if _forbidden(n)]
    assert not bad, bad


#: PyTorch's fused calls for the functions the port's kernels compute
_LIBRARY_KERNELS = {"scaled_dot_product_attention", "layer_norm",
                    "cross_entropy", "compile"}


def _is_regex_compile(node) -> bool:
    """``re.compile``: a regular expression, not ``torch.compile``."""
    return (isinstance(node, ast.Attribute) and node.attr == "compile"
            and isinstance(node.value, ast.Name) and node.value.id == "re")


def test_package_calls_no_library_kernel():
    files = sorted(PORT.rglob("*.py"))
    mods = {p.relative_to(PORT).as_posix() for p in files}
    assert {"ops/cuda/attention.py", "ops/cuda/layernorm.py",
            "ops/cuda/xent.py", "ops/losses.py", "optimize/transforms.py",
            "utils/tree_math.py"} <= mods
    bad = []
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
            name = (node.attr if isinstance(node, ast.Attribute)
                    else node.id if isinstance(node, ast.Name) else None)
            if _is_regex_compile(node):
                continue
            if name in _LIBRARY_KERNELS:
                bad.append(f"{path.relative_to(ROOT)}:{node.lineno} {name}")
    assert not bad, bad


def test_plot_and_clustering_import_without_matplotlib():
    """The card's machine has no matplotlib: importing the port's plot and
    clustering packages must not need it (the renderers import it on
    their first call), and the tagger's sample corpus ships with the
    port.  Checked in a fresh interpreter."""
    import subprocess
    import sys

    code = ("import sys\n"
            "import deeplearning4j_tpu_torch.plot\n"
            "import deeplearning4j_tpu_torch.clustering\n"
            "from deeplearning4j_tpu_torch.text import annotator\n"
            "assert 'matplotlib' not in sys.modules, 'matplotlib imported'\n"
            "assert 'jax' not in sys.modules, 'jax imported'\n"
            "p = annotator._DATA / 'pos_sample.txt'\n"
            "assert p.is_file() and 'deeplearning4j_tpu_torch' in str(p)\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
    assert (PORT / "text" / "data" / "pos_sample.txt").is_file()


def test_guard_flags_what_it_should():
    assert _forbidden("jax.numpy") and _forbidden("deeplearning4j_tpu.ops")
    assert _forbidden("ml_dtypes")
    # only re.compile is let through the library-kernel guard
    expr = ast.parse("re.compile(p); torch.compile(f); compile(s)").body
    assert [_is_regex_compile(e.value.func) for e in expr] == [
        True, False, False]
    assert not _forbidden("deeplearning4j_tpu_torch.ops")


def _entry_points(tmp_path):
    from deeplearning4j_tpu_torch import resolve_device
    from deeplearning4j_tpu_torch.models import transformer as ttr
    from deeplearning4j_tpu_torch.models import zoo
    from deeplearning4j_tpu_torch.datasets import prefetch_to_device
    from deeplearning4j_tpu_torch.optimize import transforms as tx
    from deeplearning4j_tpu_torch.parallel import DataParallelTrainer, Driver
    from deeplearning4j_tpu_torch.parallel.scaleout import StateTracker
    from deeplearning4j_tpu_torch.serving import InferenceEngine
    from deeplearning4j_tpu_torch.text.scaleout_embeddings import (
        Word2VecPerformer)

    cfg = ttr.TransformerConfig(vocab_size=11, d_model=8, n_heads=2,
                                n_layers=1, d_ff=16, max_len=8)
    cpu_model = ttr.TransformerLM(cfg, device="cpu")
    params = cpu_model.init()
    from deeplearning4j_tpu_torch import __main__ as cli
    from deeplearning4j_tpu_torch.nn import MultiLayerNetwork
    from deeplearning4j_tpu_torch.ops import rng

    mlp = zoo.mlp(4, 3, device="cpu")
    from deeplearning4j_tpu_torch import text
    from deeplearning4j_tpu_torch.models import lstm, resnet

    rcfg = resnet.ResNetConfig.resnet18(num_classes=3, width=4)
    corpus = ["a b c d e f"] * 4
    from deeplearning4j_tpu_torch.clustering import KMeansClustering
    from deeplearning4j_tpu_torch.models.rntn import RNTN
    from deeplearning4j_tpu_torch.plot import Tsne, render_word_vectors
    from deeplearning4j_tpu_torch.text.annotator import (
        AveragedPerceptronTagger, pos_tag_viterbi)
    from deeplearning4j_tpu_torch.utils import Viterbi, viterbi_decode

    class Words:
        """A stand-in embedding model: two words, two vectors."""
        vocab = type("V", (), {"words": lambda self: ["a", "b"]})()

        def get_word_vector(self, w):
            return [1.0, 0.0] if w == "a" else [0.0, 1.0]

    tagger = AveragedPerceptronTagger()
    tagger.classes = ["X", "Y"]
    return {
        "RNTN": lambda: RNTN(),
        "KMeansClustering": lambda: KMeansClustering(2),
        "Tsne": lambda: Tsne(),
        "render_word_vectors": lambda: render_word_vectors(Words()),
        "Viterbi": lambda: Viterbi(["x", "y"]),
        "viterbi_decode": lambda: viterbi_decode([[0.0, 1.0]],
                                                 [[0.0, 0.0], [0.0, 0.0]]),
        "pos_tag_viterbi": lambda: pos_tag_viterbi(["a"], tagger),
        "LSTMSequenceModel": lambda: lstm.LSTMSequenceModel(4, 8),
        "ResNet": lambda: resnet.ResNet(rcfg),
        "resnet.init_params": lambda: resnet.init_params(
            torch.Generator(), rcfg),
        "resnet.init_batch_stats": lambda: resnet.init_batch_stats(rcfg),
        "Word2Vec": lambda: text.Word2Vec(corpus),
        "Glove": lambda: text.Glove(corpus),
        "ParagraphVectors": lambda: text.ParagraphVectors(corpus),
        "LMTokenBatchIterator": lambda: text.LMTokenBatchIterator(
            text.LMCorpus(corpus), 2, 4),
        "MultiLayerNetwork": lambda: MultiLayerNetwork(mlp.conf),
        "MultiLayerNetwork.load": lambda: MultiLayerNetwork.load(
            _saved(mlp, tmp_path)),
        "zoo.mlp": lambda: zoo.mlp(4, 3),
        "zoo.dbn": lambda: zoo.dbn(4, 3),
        "zoo.stacked_denoising_autoencoder":
            lambda: zoo.stacked_denoising_autoencoder(4, 3),
        "zoo.lenet": lambda: zoo.lenet(10),
        "RngStream": lambda: rng.RngStream(0),
        "key_for": lambda: rng.key_for(0),
        "cli train": lambda: cli.main(["train", "--dataset", "iris"]),
        "cli evaluate": lambda: cli.main(["evaluate", _saved(mlp, tmp_path)]),
        "resolve_device": lambda: resolve_device(),
        "resolve_device_cuda": lambda: resolve_device("cuda"),
        "TransformerLM": lambda: ttr.TransformerLM(cfg),
        "init_params": lambda: ttr.init_params(torch.Generator(), cfg),
        "init_decode_cache": lambda: ttr.init_decode_cache(cfg, 1),
        "init_paged_cache": lambda: ttr.init_paged_cache(cfg, 2, 4),
        "InferenceEngine": lambda: InferenceEngine(cpu_model, params),
        "init_cls_head": lambda: ttr.init_cls_head(torch.Generator(), cfg, 2),
        "draft_lm": lambda: zoo.draft_lm(cfg),
        "DataParallelTrainer": lambda: DataParallelTrainer(
            lambda p, x, y, g: x.sum(), tx.sgd_lr(0.1)),
        "prefetch_to_device": lambda: prefetch_to_device([]),
        "Driver": lambda: Driver(lambda p, x, y, g: x.sum(), tx.sgd_lr(0.1)),
        "Word2VecPerformer": lambda: Word2VecPerformer(StateTracker()),
    }


def _saved(net, tmp_path) -> str:
    path = str(tmp_path / "net.pkl")
    net.save(path)
    return path


@pytest.mark.parametrize("name", sorted([
    "resolve_device", "resolve_device_cuda", "TransformerLM", "init_params",
    "init_decode_cache", "init_paged_cache", "InferenceEngine",
    "init_cls_head", "draft_lm", "DataParallelTrainer",
    "prefetch_to_device", "MultiLayerNetwork", "MultiLayerNetwork.load",
    "zoo.mlp", "zoo.dbn", "zoo.stacked_denoising_autoencoder", "zoo.lenet",
    "RngStream", "key_for", "cli train", "cli evaluate",
    "LSTMSequenceModel", "ResNet", "resnet.init_params",
    "resnet.init_batch_stats", "Word2Vec", "Glove", "ParagraphVectors",
    "LMTokenBatchIterator", "RNTN", "KMeansClustering", "Tsne",
    "render_word_vectors", "Viterbi", "viterbi_decode", "pos_tag_viterbi",
    "Driver", "Word2VecPerformer"]))
def test_entry_points_raise_without_cuda(name, monkeypatch, tmp_path):
    """Without ``device="cpu"`` an entry point asks for CUDA; with no GPU
    (forced here, so the test means the same on any machine) it raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fn = _entry_points(tmp_path)[name]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fn()


def test_a_spawned_worker_imports_no_jax_and_no_cuda(tmp_path):
    """A worker process of the port (``python -m
    deeplearning4j_tpu_torch.parallel.worker_main``, spawned by
    ``ProcessDistributedRunner``) has neither ``jax`` nor
    ``deeplearning4j_tpu`` in ``sys.modules`` once it has performed a job,
    and a host performer never initialised CUDA there."""
    from deeplearning4j_tpu_torch.parallel.procrunner import (
        ProcessDistributedRunner)
    from deeplearning4j_tpu_torch.parallel.scaleout import (
        CollectionJobIterator)
    from chip_smoke import _worker_records as read_records

    state = tmp_path / "state"
    runner = ProcessDistributedRunner(
        CollectionJobIterator(["a b", "b c"]),
        "chip_smoke:probed_slow_word_count", state_dir=state, n_workers=1,
        worker_env={"OMP_NUM_THREADS": "1"})
    runner.run(max_wall_s=60.0)
    recs = read_records(state)
    assert recs and all(r["forbidden"] == [] for r in recs), recs
    assert not any(r["cuda_initialized"] for r in recs)
    assert {r["main"] for r in recs} == {
        "deeplearning4j_tpu_torch.parallel.worker_main"}


def test_kernel_wrappers_refuse_non_cuda_devices():
    """Wrappers take the plain version only for CPU tensors: another
    device is refused, never silently routed somewhere else."""
    from deeplearning4j_tpu_torch.ops.cuda import matmul_int8 as tmm
    from deeplearning4j_tpu_torch.ops.cuda import paged_attention as tpa

    x = torch.zeros((1, 4), device="meta")
    qw = tmm.QuantizedLinear(torch.zeros((4, 3), dtype=torch.int8,
                                         device="meta"),
                             torch.ones((3,), device="meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        tmm.int8_matmul(x, qw)
    q = torch.zeros((1, 2, 4), device="meta")
    pool = torch.zeros((2, 4, 2, 4), device="meta")
    bt = torch.zeros((1, 1), dtype=torch.int32, device="meta")
    ln = torch.ones((1,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tpa.paged_attention(q, pool, pool, bt, ln)


@pytest.mark.parametrize("kernel", ["flash", "fused", "layernorm", "xent"])
def test_training_kernel_wrappers_refuse_non_cuda_devices(kernel):
    from deeplearning4j_tpu_torch.ops.cuda import attention as tat
    from deeplearning4j_tpu_torch.ops.cuda import layernorm as tln
    from deeplearning4j_tpu_torch.ops.cuda import xent as txe

    def meta(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device="meta")

    calls = {
        "flash": lambda: tat.flash_attention(*(meta(1, 8, 2, 32),) * 3),
        "fused": lambda: tat.fused_attention(*(meta(1, 8, 2, 32),) * 3),
        "layernorm": lambda: tln.fused_residual_layernorm(
            meta(4, 8), meta(4, 8), meta(8), meta(8)),
        "xent": lambda: txe.blocked_cross_entropy(
            meta(4, 8), meta(8, 5), meta(4, dtype=torch.int32)),
    }
    with pytest.raises(ValueError, match="unsupported device"):
        calls[kernel]()
