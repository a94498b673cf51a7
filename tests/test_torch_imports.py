"""Import guard and device rule of the PyTorch port.

The port (``deeplearning4j_tpu_torch/``, ``chip_smoke.py`` and
``int8_probe.py``) must import neither ``jax`` nor anything of
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
                                         ROOT / "int8_probe.py"]


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top == "jax" or top == "jaxlib" or top == "deeplearning4j_tpu"


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
            "parallel/trainer.py", "datasets/dataset.py",
            "datasets/iterator.py"} <= mods
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
            if name in _LIBRARY_KERNELS:
                bad.append(f"{path.relative_to(ROOT)}:{node.lineno} {name}")
    assert not bad, bad


def test_guard_flags_what_it_should():
    assert _forbidden("jax.numpy") and _forbidden("deeplearning4j_tpu.ops")
    assert not _forbidden("deeplearning4j_tpu_torch.ops")


def _entry_points():
    from deeplearning4j_tpu_torch import resolve_device
    from deeplearning4j_tpu_torch.models import transformer as ttr
    from deeplearning4j_tpu_torch.models import zoo
    from deeplearning4j_tpu_torch.datasets import prefetch_to_device
    from deeplearning4j_tpu_torch.optimize import transforms as tx
    from deeplearning4j_tpu_torch.parallel import DataParallelTrainer
    from deeplearning4j_tpu_torch.serving import InferenceEngine

    cfg = ttr.TransformerConfig(vocab_size=11, d_model=8, n_heads=2,
                                n_layers=1, d_ff=16, max_len=8)
    cpu_model = ttr.TransformerLM(cfg, device="cpu")
    params = cpu_model.init()
    return {
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
    }


@pytest.mark.parametrize("name", sorted([
    "resolve_device", "resolve_device_cuda", "TransformerLM", "init_params",
    "init_decode_cache", "init_paged_cache", "InferenceEngine",
    "init_cls_head", "draft_lm", "DataParallelTrainer",
    "prefetch_to_device"]))
def test_entry_points_raise_without_cuda(name, monkeypatch):
    """Without ``device="cpu"`` an entry point asks for CUDA; with no GPU
    (forced here, so the test means the same on any machine) it raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fn = _entry_points()[name]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fn()


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
