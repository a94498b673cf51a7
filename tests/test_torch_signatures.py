"""The port's public signatures against the JAX package's.

A caller of the JAX package's serving layer (the router included),
transformer, int8 matmul, trainer, checkpoints, resilience, observability
and control modules should run against the port as it is.  The cost model
keeps the reference's signatures: where the reference reads XLA's cost
analysis of a jitted function, ``CostModel.capture`` counts the same
function on fake tensors, through the same parameters.  For every public function and class (its
``__init__`` and public methods) that the port's modules in
:data:`MODULES` share with their reference counterparts, the
parameters must agree in name, order, kind and default, apart from the
differences listed in :data:`ALLOWED`: one entry a parameter, each with
its reason and the ``ROADMAP.md`` item that removes it (or why it stays).
Annotations are not compared (``torch.Tensor`` against ``jax.Array``);
dtype defaults are compared by name, and an object default (a package's
``METRICS``) by its class's name.
"""

import importlib
import inspect

import pytest

MODULES = [
    ("deeplearning4j_tpu_torch.serving.batcher",
     "deeplearning4j_tpu.serving.batcher"),
    ("deeplearning4j_tpu_torch.serving.client",
     "deeplearning4j_tpu.serving.client"),
    ("deeplearning4j_tpu_torch.serving.engine",
     "deeplearning4j_tpu.serving.engine"),
    ("deeplearning4j_tpu_torch.serving.paging",
     "deeplearning4j_tpu.serving.paging"),
    ("deeplearning4j_tpu_torch.serving.server",
     "deeplearning4j_tpu.serving.server"),
    ("deeplearning4j_tpu_torch.models.transformer",
     "deeplearning4j_tpu.models.transformer"),
    ("deeplearning4j_tpu_torch.ops.cuda.matmul_int8",
     "deeplearning4j_tpu.ops.pallas.matmul_int8"),
    ("deeplearning4j_tpu_torch.ops.cuda.attention",
     "deeplearning4j_tpu.ops.flash_attention"),
    ("deeplearning4j_tpu_torch.ops.cuda.attention",
     "deeplearning4j_tpu.ops.pallas.attention"),
    *[(f"deeplearning4j_tpu_torch.ops.cuda.{m}",
       f"deeplearning4j_tpu.ops.pallas.{m}")
      for m in ("layernorm", "xent", "paged_attention", "kv_quant",
                "registry")],
    ("deeplearning4j_tpu_torch.serving.disagg.migrate",
     "deeplearning4j_tpu.serving.disagg.migrate"),
    ("deeplearning4j_tpu_torch.serving.disagg.scheduler",
     "deeplearning4j_tpu.serving.disagg.scheduler"),
    ("deeplearning4j_tpu_torch.online.capture",
     "deeplearning4j_tpu.online.capture"),
    ("deeplearning4j_tpu_torch.online.loop",
     "deeplearning4j_tpu.online.loop"),
    ("deeplearning4j_tpu_torch.observability.core",
     "deeplearning4j_tpu.observability.core"),
    ("deeplearning4j_tpu_torch.observability.metrics",
     "deeplearning4j_tpu.observability.metrics"),
    ("deeplearning4j_tpu_torch.observability.tracing",
     "deeplearning4j_tpu.observability.tracing"),
    ("deeplearning4j_tpu_torch.observability.flightrec",
     "deeplearning4j_tpu.observability.flightrec"),
    ("deeplearning4j_tpu_torch.observability.goodput",
     "deeplearning4j_tpu.observability.goodput"),
    ("deeplearning4j_tpu_torch.observability.device",
     "deeplearning4j_tpu.observability.device"),
    ("deeplearning4j_tpu_torch.resilience.faults",
     "deeplearning4j_tpu.resilience.faults"),
    ("deeplearning4j_tpu_torch.resilience.supervisor",
     "deeplearning4j_tpu.resilience.supervisor"),
    ("deeplearning4j_tpu_torch.parallel.mesh",
     "deeplearning4j_tpu.parallel.mesh"),
    ("deeplearning4j_tpu_torch.parallel.zero",
     "deeplearning4j_tpu.parallel.zero"),
    ("deeplearning4j_tpu_torch.parallel.checkpoint",
     "deeplearning4j_tpu.parallel.checkpoint"),
    ("deeplearning4j_tpu_torch.parallel.trainer",
     "deeplearning4j_tpu.parallel.trainer"),
    *[(f"deeplearning4j_tpu_torch.parallel.{m}",
       f"deeplearning4j_tpu.parallel.{m}")
      for m in ("collectives", "compile_cache", "observe")],
    ("deeplearning4j_tpu_torch.datasets.dataset",
     "deeplearning4j_tpu.datasets.dataset"),
    ("deeplearning4j_tpu_torch.datasets.iterator",
     "deeplearning4j_tpu.datasets.iterator"),
    ("deeplearning4j_tpu_torch.datasets.fetchers",
     "deeplearning4j_tpu.datasets.fetchers"),
    ("deeplearning4j_tpu_torch.datasets.mnist_idx",
     "deeplearning4j_tpu.datasets.mnist_idx"),
    ("deeplearning4j_tpu_torch.ops.dtypes", "deeplearning4j_tpu.ops.dtypes"),
    ("deeplearning4j_tpu_torch.ops.rng", "deeplearning4j_tpu.ops.rng"),
    ("deeplearning4j_tpu_torch.ops.sampling",
     "deeplearning4j_tpu.ops.sampling"),
    ("deeplearning4j_tpu_torch.ops.activations",
     "deeplearning4j_tpu.ops.activations"),
    ("deeplearning4j_tpu_torch.ops.linalg", "deeplearning4j_tpu.ops.linalg"),
    ("deeplearning4j_tpu_torch.ops.losses", "deeplearning4j_tpu.ops.losses"),
    ("deeplearning4j_tpu_torch.ops.convolution",
     "deeplearning4j_tpu.ops.convolution"),
    ("deeplearning4j_tpu_torch.nn.conf", "deeplearning4j_tpu.nn.conf"),
    ("deeplearning4j_tpu_torch.nn.weights", "deeplearning4j_tpu.nn.weights"),
    ("deeplearning4j_tpu_torch.nn.layers", "deeplearning4j_tpu.nn.layers"),
    ("deeplearning4j_tpu_torch.nn.multilayer",
     "deeplearning4j_tpu.nn.multilayer"),
    ("deeplearning4j_tpu_torch.optimize.transforms",
     "deeplearning4j_tpu.optimize.transforms"),
    ("deeplearning4j_tpu_torch.optimize.api", "deeplearning4j_tpu.optimize.api"),
    ("deeplearning4j_tpu_torch.optimize.solvers",
     "deeplearning4j_tpu.optimize.solvers"),
    ("deeplearning4j_tpu_torch.evaluation.evaluation",
     "deeplearning4j_tpu.evaluation.evaluation"),
    ("deeplearning4j_tpu_torch.models.zoo", "deeplearning4j_tpu.models.zoo"),
    ("deeplearning4j_tpu_torch.__main__", "deeplearning4j_tpu.__main__"),
    *[(f"deeplearning4j_tpu_torch.observability.{m}",
       f"deeplearning4j_tpu.observability.{m}")
      for m in ("cost", "slo", "timeseries", "fleet", "server", "kernels")],
    *[(f"deeplearning4j_tpu_torch.serving.router.{m}",
       f"deeplearning4j_tpu.serving.router.{m}")
      for m in ("ring", "replicas", "router", "server", "procserver")],
    ("deeplearning4j_tpu_torch.control.overload",
     "deeplearning4j_tpu.control.overload"),
    ("deeplearning4j_tpu_torch.control.autoscaler",
     "deeplearning4j_tpu.control.autoscaler"),
    ("deeplearning4j_tpu_torch.models.lstm", "deeplearning4j_tpu.models.lstm"),
    ("deeplearning4j_tpu_torch.models.resnet",
     "deeplearning4j_tpu.models.resnet"),
    ("deeplearning4j_tpu_torch.native.runtime",
     "deeplearning4j_tpu.native.runtime"),
    *[(f"deeplearning4j_tpu_torch.datasets.{m}",
       f"deeplearning4j_tpu.datasets.{m}") for m in ("svmlight", "records")],
    *[(f"deeplearning4j_tpu_torch.text.{m}", f"deeplearning4j_tpu.text.{m}")
      for m in ("tokenization", "sentence", "vocab", "similarity",
                "word2vec", "glove", "serializer", "paragraph_vectors",
                "vectorizers", "lm_dataset", "windows", "index", "tree",
                "treeparser", "annotator", "sentiwordnet")],
    ("deeplearning4j_tpu_torch.models.rntn", "deeplearning4j_tpu.models.rntn"),
    ("deeplearning4j_tpu_torch.models.pipeline",
     "deeplearning4j_tpu.models.pipeline"),
    ("deeplearning4j_tpu_torch.parallel.dryrun",
     "deeplearning4j_tpu.parallel.dryrun"),
    ("deeplearning4j_tpu_torch.text.sharded_embedding",
     "deeplearning4j_tpu.text.sharded_embedding"),
    *[(f"deeplearning4j_tpu_torch.parallel.{m}",
       f"deeplearning4j_tpu.parallel.{m}")
      for m in ("scaleout", "procstate", "procrunner", "performers",
                "storage", "provision", "driver")],
    ("deeplearning4j_tpu_torch.text.scaleout_embeddings",
     "deeplearning4j_tpu.text.scaleout_embeddings"),
    *[(f"deeplearning4j_tpu_torch.{m}", f"deeplearning4j_tpu.{m}")
      for m in ("clustering", "clustering.kdtree", "clustering.kmeans",
                "clustering.quadtree", "clustering.vptree", "plot",
                "plot.tsne", "plot.render_app", "plot.renderers",
                "utils.viterbi", "utils.counters", "utils.misc",
                "utils.stringgrid")],
]

_SEED = ("the port draws from a torch.Generator or an int seed: torch "
         "cannot reproduce the threefry stream of a JAX key (kept)")
_DEVICE = ("the port's entry points take the device and default to CUDA "
           "(device.py; kept)")
_GEN_DEVICE = "the generator's draw is placed on `device` (kept)"
_ONLY_MERGED = ("the routers clear only the updates they just merged: the "
                "reference's clear-all drops an update that lands during a "
                "merge (a repair; kept)")
_H100 = ("provisioning is aimed at H100 hosts (parallel/provision.py's "
         "docstring lists each difference; kept)")
_KERNELS = ("the port's hook to run the same function through its plain "
            "versions, for chip_smoke.py's kernels-vs-plain checks (kept)")

#: "module:qualname" -> {parameter: reason (-> ROADMAP.md item)}
ALLOWED = {
    "serving.engine:InferenceEngine.__init__": {
        "compile_cache_dir": "no compile cache: PyTorch runs eagerly; CUDA "
                             "graphs of the step come with B2 item 4 (-> B2)",
        "device": _DEVICE + "; keyword-only",
    },
    "serving.router.procserver:tiny_lm_factory": {
        "device": _DEVICE + " (the tests pass 'cpu'; a child process on "
                  "the card builds the same weights from a CPU generator)",
    },
    "models.transformer:TransformerLM.__init__": {
        "device": _DEVICE + "; keyword-only",
    },
    "models.transformer:TransformerLM.init": {
        "key": _SEED, "gen": _SEED,
    },
    "models.transformer:TransformerLM.init_finetune": {
        "key": _SEED, "gen": _SEED,
    },
    "models.pipeline:PipelinedTransformerLM.__init__": {
        "device": _DEVICE + "; keyword-only",
    },
    "models.pipeline:PipelinedTransformerLM.init": {
        "key": _SEED, "gen": _SEED,
    },
    "parallel.dryrun:dryrun_multichip": {
        "device": "the device every rank's model runs on (the reference "
                  "forces JAX's CPU platform in-process; kept)",
    },
    "models.transformer:TransformerLM.sample": {
        "key": _SEED, "seed": _SEED,
    },
    "models.transformer:init_params": {
        "key": _SEED, "gen": _SEED, "device": _GEN_DEVICE,
    },
    "models.transformer:init_cls_head": {
        "key": _SEED, "gen": _SEED, "device": _GEN_DEVICE,
    },
    "models.transformer:init_decode_cache": {"device": _DEVICE},
    "models.transformer:init_paged_cache": {"device": _DEVICE},
    "models.transformer:decode_step": {"int8_fn": _KERNELS},
    "models.transformer:decode_step_paged": {"int8_fn": _KERNELS},
    "models.transformer:encode_local": {"kernels": _KERNELS},
    "models.transformer:lm_head_loss": {"kernels": _KERNELS},
    "models.transformer:lm_loss_local": {"kernels": _KERNELS},
    "parallel.trainer:DataParallelTrainer.__init__": {
        "device": _DEVICE + "; keyword-only",
    },
    "parallel.scaleout:StateTracker.clear_updates": {
        "worker_ids": _ONLY_MERGED,
    },
    "parallel.procstate:FileStateTracker.clear_updates": {
        "worker_ids": _ONLY_MERGED,
    },
    "parallel.driver:Driver.__init__": {
        "device": _DEVICE + "; keyword-only (the trainer's)",
    },
    "text.scaleout_embeddings:Word2VecPerformer.__init__": {
        "device": _DEVICE + "; keyword-only (where the worker's steps run)",
    },
    "parallel.provision:PodSliceSpec.__init__": {
        "name": _H100 + ": the hosts' name prefix",
        "accelerator_type": _H100 + ": h100-<cards>, not a TPU slice type",
        "zone": _H100 + ": a zone that offers a3-highgpu hosts",
        "runtime_version": _H100 + ": the Deep Learning VM image family "
                           "(CUDA toolkit included), not a TPU runtime",
        "coordinator_port": _H100 + ": MASTER_PORT, torch's customary "
                            "29500, not the JAX coordinator's 8476",
    },
    "parallel.provision:PodSliceProvisioner.render_script": {
        "coordinator_host": _H100 + ": host 0's internal IP from "
                            "`gcloud compute instances describe`",
    },
    "datasets.iterator:prefetch_to_device": {
        "device": _DEVICE + "; keyword-only (`sharding` picks this rank's "
                  "rows, `device` where they go; kept)",
    },
    "parallel.mesh:initialize_multihost": {
        "backend": "the torch.distributed backend (NCCL or gloo), which "
                   "JAX's coordination service does not have; "
                   "keyword-only (kept)",
        "timeout_s": "how long a collective waits for a peer before the "
                     "process group fails; keyword-only (kept)",
    },
    "parallel.zero:ZeroLayout.place_flat": {
        "device": "the device the placed chunks go to (a jit's "
                  "out_shardings carry it in the reference); kept",
    },
    "ops.cuda.matmul_int8:int8_matmul": {
        "block_n": "a Pallas tiling knob; the port's launch plan picks its "
                   "tiles from the shape (kept)",
        "interpret": "Pallas interpret mode; a CPU tensor takes the plain "
                     "version (kept)",
    },
    "ops.cuda.kv_quant:init_quantized_paged_cache": {"device": _DEVICE},
    "ops.cuda.registry:KernelCandidate.__init__": {
        "source": "a candidate is a hand-written CUDA kernel (\"cuda\") or "
                  "a plain torch incumbent, where the reference's is a "
                  "Pallas kernel (\"pallas\") or a jnp one (kept)",
    },
    "ops.cuda.matmul_int8:reference_int8_matmul": {
        "_": "takes and ignores the kernel's keywords, so the registry can "
             "call both alike (kept)",
    },
    "ops.rng:RngStream.__init__": {"device": _DEVICE + "; keyword-only"},
    "ops.rng:key_for": {"device": _DEVICE + "; keyword-only"},
    "models.zoo:draft_lm": {"device": _DEVICE},
    "nn.multilayer:MultiLayerNetwork.__init__": {
        "device": _DEVICE + "; keyword-only"},
    "nn.multilayer:MultiLayerNetwork.load": {
        "device": _DEVICE + "; keyword-only"},
    **{f"models.zoo:{name}": {"device": _DEVICE + "; keyword-only"}
       for name in ("mlp", "dbn", "stacked_denoising_autoencoder", "lenet")},
    **{key: {"device": _DEVICE + "; keyword-only"} for key in (
        "models.lstm:LSTMSequenceModel.__init__",
        "models.resnet:ResNet.__init__",
        "text.word2vec:Word2Vec.__init__", "text.glove:Glove.__init__",
        "text.serializer:load_into_word2vec",
        "text.lm_dataset:LMTokenBatchIterator.__init__")},
    "models.resnet:init_params": {"key": _SEED, "gen": _SEED,
                                  "device": _DEVICE},
    "models.resnet:init_batch_stats": {"device": _DEVICE},
    "utils.viterbi:viterbi_decode": {"device": _DEVICE},
    "plot.render_app:render_word_vectors": {
        "device": _DEVICE + " (passed to Tsne)"},
    **{key: {"device": _DEVICE + "; keyword-only"} for key in (
        "utils.viterbi:Viterbi.__init__", "text.annotator:pos_tag_viterbi",
        "models.rntn:RNTN.__init__",
        "clustering.kmeans:KMeansClustering.__init__",
        "plot.tsne:Tsne.__init__")},
    **{key: {"key": _SEED, "gen": _SEED} for key in (
        "ops.sampling:binomial", "ops.sampling:gaussian",
        "ops.sampling:dropout_mask", "ops.sampling:uniform",
        "ops.sampling:normal",
        "nn.weights:init_weights", "nn.weights:init_from_conf",
        "nn.layers:dropout_mask",
        "nn.layers:Layer.init", "nn.layers:DenseLayer.init",
        "nn.layers:BasePretrainLayer.init",
        "nn.layers:BasePretrainLayer.pretrain_value_and_grad",
        "nn.layers:AutoEncoder.corrupt", "nn.layers:AutoEncoder.pretrain_loss",
        "nn.layers:AutoEncoder.pretrain_value_and_grad",
        "nn.layers:RBM.sample_hidden_given_visible",
        "nn.layers:RBM.sample_visible_given_hidden", "nn.layers:RBM.gibbs_hvh",
        "nn.layers:RBM.pretrain_value_and_grad",
        "nn.layers:RecursiveAutoEncoder.init",
        "nn.layers:RecursiveAutoEncoder.pretrain_loss",
        "nn.layers:RecursiveAutoEncoder.pretrain_value_and_grad",
        "nn.layers:LSTM.init", "nn.layers:ConvolutionDownSampleLayer.init",
        "nn.layers:BatchNorm.init", "nn.layers:Embedding.init",
        "nn.multilayer:MultiLayerNetwork.init",
        "models.lstm:LSTMSequenceModel.init", "models.resnet:ResNet.init",
        "nn.multilayer:MultiLayerNetwork.pretrain",
        "nn.multilayer:MultiLayerNetwork.finetune",
        "nn.multilayer:MultiLayerNetwork.fit",
        "nn.multilayer:MultiLayerNetwork.fit_arrays",
        "optimize.solvers:BaseOptimizer.optimize",
        "optimize.solvers:StochasticHessianFree.optimize",
        "optimize.solvers:Solver.optimize")},
}

#: the CLI's options that differ from the reference's: "command option"
#: -> reason.  Every other option of every command must match the
#: reference's in its flags, default, type and choices.
ALLOWED_CLI = {
    "main --platform": "a torch device that defaults to cuda where the "
                       "reference's is a JAX platform that defaults to cpu: "
                       "the port's entry points run on the card unless the "
                       "CPU is asked for, and raise without one (kept)",
    "train --platform": "also accepted after the command "
                        "(`train --platform cpu`), as the README writes it "
                        "(kept)",
    "evaluate --platform": "as train's (kept)",
    "scaleout --performer": "the port's WordCountPerformer: a worker "
                            "spawned with the reference's would import the "
                            "JAX package (kept)",
    "provision --name": _H100,
    "provision --accelerator-type": _H100,
    "provision --zone": _H100,
    "provision --train-argv": "the launched program is the port's CLI, "
                              "python -m deeplearning4j_tpu_torch (kept)",
    "dryrun --platform": "as train's: the ranks run on the card unless "
                         "the CPU is asked for (kept)",
}


def _members(mod) -> dict:
    """Public functions, classes' ``__init__`` and public methods defined
    in ``mod``, by qualified name."""
    out = {}
    for name, obj in vars(mod).items():
        if name.startswith("_") or getattr(obj, "__module__", None) \
                != mod.__name__:
            continue
        if inspect.isfunction(obj):
            out[name] = obj
        elif inspect.isclass(obj):
            for mname, m in vars(obj).items():
                if mname.startswith("_") and mname != "__init__":
                    continue
                f = m.__func__ if isinstance(m, (staticmethod,
                                                 classmethod)) else m
                if inspect.isfunction(f):
                    out[f"{name}.{mname}"] = f
    return out


def _default(value):
    """A default, comparable across the packages: dtypes by name, objects
    by their class's name."""
    if value is inspect.Parameter.empty:
        return "<required>"
    if isinstance(value, type) and value.__module__.split(".")[0] in (
            "deeplearning4j_tpu", "deeplearning4j_tpu_torch"):
        return "class " + value.__qualname__   # a package's own class
    text = repr(value)
    if " object at 0x" in text:      # a package's own singleton (METRICS)
        return "instance of " + type(value).__qualname__
    for prefix in ("torch.", "<class 'jax.numpy.", "<class 'numpy."):
        if text.startswith(prefix):
            return "dtype " + text[len(prefix):].rstrip("'>")
    return text


def _params(fn, skip) -> list:
    return [(p.name, p.kind, _default(p.default))
            for p in inspect.signature(fn).parameters.values()
            if p.name not in skip]


def _pairs():
    for port_name, ref_name in MODULES:
        port = _members(importlib.import_module(port_name))
        ref = _members(importlib.import_module(ref_name))
        short = port_name.removeprefix("deeplearning4j_tpu_torch.")
        for qual in sorted(set(port) & set(ref)):
            yield f"{short}:{qual}", port[qual], ref[qual]


PAIRS = list(_pairs())


def test_the_comparison_covers_the_ported_surface():
    keys = {k for k, _, _ in PAIRS}
    for must in ("serving.engine:InferenceEngine.__init__",
                 "serving.engine:kv_page_bytes",
                 "serving.server:ModelServer.__init__",
                 "models.transformer:TransformerLM.sample",
                 "models.transformer:decode_step_paged",
                 "ops.cuda.matmul_int8:int8_matmul",
                 "observability.cost:CostModel.capture",
                 "observability.slo:SLOEvaluator.__init__",
                 "observability.fleet:FleetScraper.__init__",
                 "serving.router.router:PrefixRouter.generate",
                 "serving.router.replicas:ProcessReplica.__init__",
                 "serving.batcher:RequestQueue.__init__",
                 "control.autoscaler:Autoscaler.__init__",
                 "control.overload:BrownoutController.__init__",
                 "parallel.mesh:make_mesh", "parallel.mesh:MeshSpec.resolve",
                 "parallel.collectives:reduce_scatter",
                 "parallel.zero:ZeroLayout.__init__",
                 "parallel.compile_cache:setup_compile_cache",
                 "optimize.transforms:init_sharded",
                 "models.transformer:TransformerLM.init_opt_zero1",
                 "parallel.driver:Driver.__init__", "parallel.driver:Driver.run",
                 "parallel.scaleout:DistributedRunner.__init__",
                 "parallel.scaleout:DistributedRunner.retire_worker",
                 "parallel.procrunner:ProcessDistributedRunner.__init__",
                 "parallel.procstate:FileStateTracker.evict_stale",
                 "parallel.storage:ConfigRegistry.register",
                 "parallel.provision:PodSliceProvisioner.apply",
                 "text.scaleout_embeddings:Word2VecJobIterator.__init__"):
        assert must in keys
    assert len(PAIRS) >= 50
    assert set(ALLOWED) <= keys, set(ALLOWED) - keys


@pytest.mark.parametrize("key,port_fn,ref_fn", PAIRS,
                         ids=[k for k, _, _ in PAIRS])
def test_signature_matches_the_reference(key, port_fn, ref_fn):
    allowed = ALLOWED.get(key, {})
    port = _params(port_fn, allowed)
    ref = _params(ref_fn, allowed)
    assert port == ref, (f"{key}: port {inspect.signature(port_fn)} vs "
                         f"reference {inspect.signature(ref_fn)}")
    # every allowance is a real difference: a name on one side only, or a
    # parameter whose default differs
    pp = inspect.signature(port_fn).parameters
    rp = inspect.signature(ref_fn).parameters
    for name in allowed:
        one_side = (name in pp) != (name in rp)
        assert one_side or _default(pp[name].default) != _default(
            rp[name].default), f"{key}: {name} is not a difference"


def test_reference_keywords_reach_the_port():
    """The drifts the allowlist does not cover, now repaired, and the
    reference's answer to a missing checkpoint directory."""
    from deeplearning4j_tpu_torch.models import transformer as ttr
    from deeplearning4j_tpu_torch.serving import (InferenceEngine,
                                                  ServingConfig,
                                                  kv_page_bytes)

    cfg = ttr.TransformerConfig(vocab_size=64, d_model=32, n_heads=2,
                                n_layers=2, d_ff=64, max_len=32)
    assert kv_page_bytes(cfg, 16, kv_quant="int8") < kv_page_bytes(cfg, 16)
    names = list(inspect.signature(InferenceEngine).parameters)
    assert names[:4] == ["model", "params", "checkpoint", "cfg"]
    model = ttr.TransformerLM(cfg, device="cpu")
    params = model.init()
    # a checkpoint directory opens read-only, as the reference's does: a
    # missing one fails loudly instead of serving from an empty directory
    with pytest.raises(FileNotFoundError, match="does not exist"):
        InferenceEngine(model, params, "/no/such/checkpoint",
                        ServingConfig(), device="cpu")
    with pytest.raises(ValueError):
        InferenceEngine(model, cfg=ServingConfig(), device="cpu")


def _cli_options(mod) -> dict:
    """``{"command option": (default, type, choices)}`` of a package's
    CLI parser, captured from its ``main`` without running a command."""
    import argparse

    class Captured(Exception):
        pass

    def capture(self, *a, **kw):
        raise Captured(self)

    orig = argparse.ArgumentParser.parse_args
    argparse.ArgumentParser.parse_args = capture
    try:
        mod.main([])
    except Captured as e:
        parser = e.args[0]
    finally:
        argparse.ArgumentParser.parse_args = orig
    out = {}

    def walk(p, name):
        for a in p._actions:
            if isinstance(a, argparse._SubParsersAction):
                for cmd, sp in a.choices.items():
                    walk(sp, cmd)
            elif a.option_strings and "--help" not in a.option_strings:
                key = f"{name} {max(a.option_strings, key=len)}"
                out[key] = (repr(a.default), getattr(a.type, "__name__", None),
                            a.choices)
            elif not a.option_strings:
                out[f"{name} <{a.dest}>"] = (None, None, None)

    walk(parser, "main")
    return out


def test_cli_options_match_the_reference():
    import deeplearning4j_tpu.__main__ as ref
    import deeplearning4j_tpu_torch.__main__ as port

    p, r = _cli_options(port), _cli_options(ref)
    assert {k for k in p if k.startswith("train ")} >= {
        "train --model", "train --dataset", "train --batch", "train --out"}
    for key in sorted(set(p) | set(r)):
        if key in ALLOWED_CLI:
            assert key not in r or p.get(key) != r[key], \
                f"{key} is not a difference"
            continue
        assert p.get(key) == r.get(key), (key, p.get(key), r.get(key))
    assert set(ALLOWED_CLI) <= set(p)


#: names the reference's ``parallel`` package exports that the port's
#: does not: name -> reason (-> ROADMAP.md item)
PARALLEL_EXPORTS_ALLOWED: dict = {}


def test_parallel_exports_match_the_reference():
    import deeplearning4j_tpu.parallel as ref
    import deeplearning4j_tpu_torch.parallel as port

    missing = set(ref.__all__) - set(port.__all__)
    assert missing == set(PARALLEL_EXPORTS_ALLOWED), missing
    for name in set(ref.__all__) - missing:
        assert hasattr(port, name), name
    for name in ("psum", "pmean", "all_gather", "reduce_scatter",
                 "reduce_scatter_or_psum", "all_gather_or_identity",
                 "ppermute", "ring_shift", "axis_index", "barrier_sum"):
        from deeplearning4j_tpu_torch.parallel import collectives

        assert callable(getattr(collectives, name)), name
