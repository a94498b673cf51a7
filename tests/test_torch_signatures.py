"""The port's public signatures against the JAX package's.

A caller of the JAX package's serving layer, transformer, int8 matmul,
trainer, checkpoints, resilience and observability modules should run
against the port as it is.  For every public function and class (its
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
    ("deeplearning4j_tpu_torch.datasets.dataset",
     "deeplearning4j_tpu.datasets.dataset"),
    ("deeplearning4j_tpu_torch.datasets.iterator",
     "deeplearning4j_tpu.datasets.iterator"),
]

_SEED = ("the port draws from a torch.Generator or an int seed: torch "
         "cannot reproduce the threefry stream of a JAX key (kept)")
_DEVICE = ("the port's entry points take the device and default to CUDA "
           "(device.py; kept)")
_GEN_DEVICE = "the generator's draw is placed on `device` (kept)"
_KERNELS = ("the port's hook to run the same function through its plain "
            "versions, for chip_smoke.py's kernels-vs-plain checks (kept)")

#: "module:qualname" -> {parameter: reason (-> ROADMAP.md item)}
ALLOWED = {
    "serving.batcher:GenerateRequest.__init__": {
        "trace_id": "the engine's tracing (-> A6, A7)",
        "parent_span_id": "the engine's tracing (-> A6, A7)",
        "root_span_id": "the engine's tracing (-> A6, A7)",
        "submitted_perf": "the engine's tracing (-> A6, A7)",
    },
    "serving.batcher:RequestQueue.__init__": {
        "depth_gauge": "per-tier queue gauges come with the prefill/decode "
                       "roles (-> A6)",
        "metrics": "the port's queue publishes to its engine's registry, "
                   "the reference's to the process-wide one; keyword-only "
                   "(kept until A7 ports the global registry)",
    },
    "serving.engine:InferenceEngine.__init__": {
        "compile_cache_dir": "no compile cache: PyTorch runs eagerly; CUDA "
                             "graphs of the step come with B2 item 4 (-> A6)",
        "device": _DEVICE + "; keyword-only",
        "registry": "the engine's own metrics registry, where the reference "
                    "publishes to the process-wide one; keyword-only "
                    "(kept until A7)",
    },
    "serving.server:ModelServer.__init__": {
        "registry": "default: the engine's registry, where the reference "
                    "serves the process-wide one (kept until A7)",
        "capture": "online capture (-> A8)",
    },
    "models.transformer:TransformerLM.__init__": {
        "device": _DEVICE + "; keyword-only",
    },
    "models.transformer:TransformerLM.build_train_step": {
        "zero1": "ZeRO-1 over a mesh (-> A5, A10)",
    },
    "models.transformer:TransformerLM.build_finetune_step": {
        "zero1": "ZeRO-1 over a mesh (-> A5, A10)",
    },
    "models.transformer:TransformerLM.init": {
        "key": _SEED, "gen": _SEED,
    },
    "models.transformer:TransformerLM.init_finetune": {
        "key": _SEED, "gen": _SEED,
    },
    "models.transformer:TransformerLM.init_opt": {
        "specs": "optimizer-state sharding specs (-> A5, A10)",
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
    "datasets.iterator:prefetch_to_device": {
        "device": _DEVICE + "; keyword-only (the reference places by "
                  "`sharding`, which waits for a mesh: -> A10)",
    },
    "ops.cuda.matmul_int8:int8_matmul": {
        "block_n": "a Pallas tiling knob; the port's launch plan picks its "
                   "tiles from the shape (kept)",
        "interpret": "Pallas interpret mode; a CPU tensor takes the plain "
                     "version (kept)",
    },
    "ops.cuda.matmul_int8:reference_int8_matmul": {
        "_": "takes and ignores the kernel's keywords, so the registry can "
             "call both alike (kept)",
    },
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
                 "ops.cuda.matmul_int8:int8_matmul"):
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
