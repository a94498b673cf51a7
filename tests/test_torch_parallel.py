"""The port's data-parallel compute plane against the JAX package, over
gloo CPU ranks.

Ranks are processes of one pool per module (``tests/torch_ranks.py``):
four gloo ranks, so a dp=2 mesh leaves two ranks outside it (they build
the mesh too, and compute nothing).  Each case runs the same seeded numpy
inputs through the port's ranks and through the JAX package's
``DataParallelTrainer`` on ``make_mesh(MeshSpec(dp=N),
devices=jax.devices()[:N])`` (the conftest's 8 virtual CPU devices).

Tolerances (float32): across the packages, and across reductions of
another order (reduce-scatter against all-reduce, dp=4), 1e-5 absolute
— the reference's documented cross-width window
(``tests/test_elastic_reshard.py``).  Within the port, ZeRO stage 1 is
the stage-0 reduction (one all-reduce of the same packed buffer) and is
held bitwise.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as JP

from deeplearning4j_tpu.models import transformer as jtr
from deeplearning4j_tpu.optimize import transforms as JT
from deeplearning4j_tpu.parallel import DataParallelTrainer as JTrainer
from deeplearning4j_tpu.parallel import collectives as jc
from deeplearning4j_tpu.parallel.mesh import MeshSpec as JSpec
from deeplearning4j_tpu.parallel.mesh import make_mesh as jmake
from deeplearning4j_tpu.parallel.zero import ZeroLayout as JLayout
from deeplearning4j_tpu_torch.parallel.mesh import MeshSpec as TSpec
from torch_ranks import RankPool, np_data, np_params

try:
    from jax import shard_map
except ImportError:  # pragma: no cover - older jax
    from jax.experimental.shard_map import shard_map

TOL = 1e-5        # float32, across packages and reduction orders
WORLD = 4


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    p = RankPool(WORLD, tmp_path_factory.mktemp("ranks"))
    yield p
    p.close()


def _jmesh(n):
    return jmake(JSpec(dp=n), devices=jax.devices()[:n])


def _jloss(params, x, y, key=None):
    return ((x @ params["w"] + params["b"] - y) ** 2).mean()


def _jtx(name):
    return {"adam": lambda: JT.adam(1e-2),
            "momentum": lambda: JT.chain(JT.momentum(0.9),
                                         JT.sgd_lr(5e-2))}[name]()


@functools.lru_cache(maxsize=None)
def _reference(n, stage, tx, steps, router="iterative_reduce",
               average_every=8):
    tr = JTrainer(_jloss, _jtx(tx), mesh=_jmesh(n), router=router,
                  average_every=average_every, zero_stage=stage)
    state = tr.init_state(np_params())
    losses = []
    for x, y in np_data(steps):
        state, lazy = tr.step(state, x, y)
        losses.append(float(lazy))
    params = jax.tree_util.tree_map(np.asarray,
                                    jax.device_get(tr.final_params(state)))
    return np.array(losses), params


def _close(got, want, tol=TOL, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=tol, err_msg=what)


# ------------------------------------------------------------------ mesh

@pytest.mark.parametrize("kw,n", [
    ({}, 8), ({"dp": 2}, 2), ({"dp": -1, "tp": 2}, 8), ({"dp": 4}, 4),
    ({"dp": 2, "tp": 2, "pp": 2}, 8), ({"dp": 3}, 4),
    ({"dp": -1, "sp": -1}, 4),
    ({"dp": -1, "tp": 3}, 8)])
def test_mesh_spec_resolve_matches_the_reference(kw, n):
    """Sizes, and the ValueErrors, of ``MeshSpec.resolve`` (host logic)."""
    def out(spec_cls):
        try:
            return spec_cls(**kw).resolve(n)
        except ValueError as e:
            return ("ValueError", str(e))

    assert out(TSpec) == out(JSpec)


def test_mesh_shrink_grow_and_groups(pool):
    """``elastic_mesh`` / ``shrink_mesh`` / ``grow_mesh`` over the world's
    ranks, as the reference's over its devices; every rank builds every
    mesh, and only the members' collectives run."""
    res = pool.run("mesh_helpers")
    assert res[0]["sizes"] == [4, 2, 4, 4]
    assert res[0]["survivors"] == [0, 1]
    assert [r["member_of_small"] for r in res] == [True, True, False, False]
    assert all(r["psum_small"] == (2.0 if r["member_of_small"] else None)
               for r in res)
    assert res[0]["empty"] == "ValueError"


# ------------------------------------------------------------- collectives

def _jcollectives(n):
    """The reference's collectives under shard_map on the same inputs."""
    mesh = _jmesh(n)
    xs = np.stack([np.arange(24, dtype=np.float32).reshape(4, 6) * (r + 1) + r
                   for r in range(n)])
    x3 = np.stack([np.arange(3 * 4 * n, dtype=np.float32).reshape(3, 4 * n)
                   * (r + 1) for r in range(n)])

    def per_rank(fn, arr=xs):
        f = shard_map(lambda a: fn(a[0])[None], mesh=mesh,
                      in_specs=JP("dp"), out_specs=JP("dp"), check_vma=False)
        return np.asarray(f(jnp.asarray(arr)))

    return {
        "psum": per_rank(lambda a: jc.psum(a, "dp")),
        "pmean": per_rank(lambda a: jc.pmean(a, "dp")),
        "all_gather": per_rank(lambda a: jc.all_gather(a, "dp")),
        "all_gather_tiled": per_rank(
            lambda a: jc.all_gather(a, "dp", tiled=True)),
        "reduce_scatter": per_rank(
            lambda a: jc.reduce_scatter(a.reshape(-1)[:4 * n], "dp")),
        "reduce_scatter_dim1": per_rank(
            lambda a: jc.reduce_scatter(a, "dp", scatter_dimension=1), x3),
        "rs_or_psum": per_rank(
            lambda a: jc.reduce_scatter_or_psum(a.reshape(-1)[:4 * n], "dp",
                                                n)),
        "ag_or_identity": per_rank(
            lambda a: jc.all_gather_or_identity(a[0], "dp", n)),
        "ppermute": per_rank(lambda a: jc.ppermute(
            a, "dp", [(i, (i + 1) % n) for i in range(n)])),
        "ppermute_partial": per_rank(
            lambda a: jc.ppermute(a, "dp", [(0, n - 1)])),
        "ring_shift": per_rank(lambda a: jc.ring_shift(a, "dp", n, shift=-1)),
        "axis_index": per_rank(lambda a: jc.axis_index("dp")),
        "barrier_sum": per_rank(lambda a: jc.barrier_sum("dp")),
    }


@pytest.mark.parametrize("n", [2, 4])
def test_collectives_match_the_reference(pool, n):
    """Every collective, per rank, equals the reference's under shard_map
    (integers in float32: exact)."""
    got = pool.run("collectives", n)
    want = _jcollectives(n)
    for r in range(n):
        assert set(got[r]) == set(want)
        for k, v in want.items():
            np.testing.assert_array_equal(got[r][k], v[r], err_msg=k)
    assert all(g is None for g in got[n:])


# ------------------------------------------------------------- ZeRO layout

@pytest.mark.parametrize("n", [2, 4])
def test_layout_arithmetic_matches_the_reference(pool, n):
    res = pool.run("layout", n)
    z = JLayout(_jmesh(n), _jtx("momentum"), np_params())
    assert res[0]["padded"] == [z.padded_size(s) for s in (1, n, n + 1, 9)]
    assert res[0]["chunk"] == [z.chunk_size(s) for s in (1, n, n + 1, 9)]
    p = np_params()
    flat = jax.tree_util.tree_map(np.asarray, z.flatten_tree(p))
    for r in range(n):
        assert res[r]["roundtrip"]
        for k in p:
            k_chunk = z.chunk_size(p[k].size)
            want = flat[k][r * k_chunk:(r + 1) * k_chunk]
            np.testing.assert_array_equal(res[r]["chunks"][k], want)
            np.testing.assert_array_equal(res[r]["placed"][k], want)
            np.testing.assert_array_equal(res[r]["gathered"][k], p[k])
        assert set(res[r]["state_specs"]) == {"P('dp',)"}
        assert res[r]["decay_mask"] == {"w": True, "b": False}


# ------------------------------------------------------------------ stages

@pytest.mark.parametrize("tx", ["momentum", "adam"])
@pytest.mark.parametrize("n", [2, 4])
def test_zero_stages_match_the_reference(pool, n, tx):
    """Stages 0-3 at dp=n: each stage's losses and final params against
    the reference's same stage (1e-5), and against the port's stage 0 at
    the same width (stage 1 bitwise: the same reduction)."""
    steps = 6
    runs = {s: pool.run("train", n, s, tx, steps) for s in (0, 1, 2, 3)}
    for s, res in runs.items():
        mine = res[0]
        assert all(r is None for r in res[n:])
        for r in range(1, n):          # every member holds the same result
            np.testing.assert_array_equal(res[r]["losses"], mine["losses"])
        jl, jp = _reference(n, s, tx, steps)
        _close(mine["losses"], jl, what=f"stage {s} losses")
        for k in jp:
            _close(mine["params"][k], jp[k], what=f"stage {s} {k}")
    base = runs[0][0]
    np.testing.assert_array_equal(runs[1][0]["losses"], base["losses"])
    for k in base["params"]:
        np.testing.assert_array_equal(runs[1][0]["params"][k],
                                      base["params"][k])
        for s in (2, 3):
            _close(runs[s][0]["params"][k], base["params"][k])
    # the state is born rank-local: each leaf a 1-D chunk of the padded
    # flat leaf (w: 6 -> 6 or 8 padded, b: 1 -> n); params too at stage 3
    z = JLayout(_jmesh(n), _jtx(tx), np_params())
    chunks = sorted({(z.chunk_size(6),), (z.chunk_size(1),)})
    assert sorted(set(runs[2][0]["tstate_shapes"])) == chunks
    assert sorted(set(runs[3][0]["params_shapes"])) == chunks
    assert runs[1][0]["params_shapes"] == [(1,), (6, 1)]


def test_zero2_fit_matches_the_step_loop(pool):
    """The async fit loop (prefetched rank rows, buckets, the lazy ring)
    gives the step loop's losses."""
    fit = pool.run("train", 2, 2, "momentum", 6, fit=True)[0]
    loop = pool.run("train", 2, 2, "momentum", 6)[0]
    np.testing.assert_array_equal(fit["losses"], loop["losses"])
    assert fit["step"] == 6


@pytest.mark.parametrize("n", [2, 4])
def test_hogwild_matches_the_reference(pool, n):
    """Local steps with averaging every 2 steps: the replica-mean losses
    and the averaged final params against the reference's."""
    res = pool.run("train", n, 0, "momentum", 7, router="hogwild",
                   average_every=2)
    jl, jp = _reference(n, 0, "momentum", 7, "hogwild", 2)
    _close(res[0]["losses"], jl)
    for k in jp:
        _close(res[0]["params"][k], jp[k])
        for r in range(1, n):
            np.testing.assert_array_equal(res[r]["params"][k],
                                          res[0]["params"][k])


# ------------------------------------------------------------------ memory

@pytest.mark.parametrize("n", [2, 4])
def test_state_bytes_shrink_per_rank(pool, n):
    """Each rank gauges what it holds: the adam state at stage 2 is the
    replicated state over n, plus at most one dp row of padding a leaf;
    the params stay whole below stage 3."""
    res = pool.run("state_bytes", n)
    d, itemsize, n_leaves = 64, 4, 4          # (mu, nu) x (w, b)
    for r in range(n):
        g0, g2 = res[r][0], res[r][2]
        rep = g0[f"train.opt_state_bytes.device.{r}"]
        shard = g2[f"train.opt_state_bytes.device.{r}"]
        assert rep == 2 * (d + 1) * itemsize
        assert rep / n <= shard <= rep / n + n_leaves * itemsize * n
        assert g2[f"train.params_bytes.device.{r}"] == (d + 1) * itemsize
        assert res[r]["n_dp"] == n


def test_prefetch_stages_each_ranks_rows(pool):
    res = pool.run("prefetch", 2)
    for r in range(2):
        for i, (a, b, k) in enumerate(res[r]):
            full = np.arange(24, dtype=np.float32).reshape(8, 3) + 100 * i
            np.testing.assert_array_equal(a, full[r * 4:(r + 1) * 4])
            np.testing.assert_array_equal(b, (np.arange(8) + 10 * i)
                                          [r * 4:(r + 1) * 4])
            assert k == i
    for r in range(2, WORLD):       # outside the mesh: the whole batch
        assert res[r][0][0].shape == (8, 3)


# ------------------------------------------------------------------ the LM

def _lm_cfg():
    return dict(vocab_size=97, d_model=32, n_heads=4, n_layers=2, d_ff=64,
                max_len=128, attention="flash", fused_ln=True,
                xent_impl="blocked", causal=False, remat=False)


def _lm_batches(steps, b=4, t=32):
    out = []
    for s in range(steps):
        rng = np.random.default_rng(20 + s)
        toks = rng.integers(0, 97, (b, t)).astype(np.int32)
        out.append((toks, np.roll(toks, -1, axis=1)))
    return out


def test_lm_zero1_step_matches_the_reference(pool):
    """``TransformerLM(cfg, mesh).build_train_step(zero1=True)`` on a
    2-layer LM at dp=2: two momentum steps from the reference's params
    against the reference's ZeRO-1 step (1e-5: SGD with momentum moves
    a param by lr x its gradient, so the packages' gradient rounding
    stays ~1e-7); the port's ZeRO-1 against its replicated step under
    adam (1e-5); the state chunks are (1, ceil(size / 2))."""
    cfg = _lm_cfg()
    jcfg = jtr.TransformerConfig(dtype=jnp.float32, **cfg)
    jp = jtr.init_params(jax.random.key(5), jcfg)
    np_p = jax.tree_util.tree_map(np.asarray, jp)
    batches = _lm_batches(2)
    model = jtr.TransformerLM(jcfg, _jmesh(2))
    tx = model._default_tx(1e-3)
    params = model.place(jp)
    opt = model.init_opt_zero1(params, tx)
    step = model.build_train_step(tx, zero1=True)
    jl = []
    for toks, tg in batches:
        params, opt, loss = step(params, opt, jnp.asarray(toks),
                                 jnp.asarray(tg))
        jl.append(float(loss))
    jparams = jax.tree_util.tree_map(np.asarray, jax.device_get(params))

    got = pool.run("lm", 2, np_p, batches, "momentum", True, cfg)[0]
    _close(got["losses"], jl, what="losses")
    for a, b in zip(jax.tree_util.tree_leaves(got["params"]),
                    jax.tree_util.tree_leaves(jparams)):
        _close(a, b)
    assert got["count"] == 2
    sizes = [int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(np_p)]
    assert sorted(got["state_shapes"]) == sorted((1, -(-s // 2))
                                                 for s in sizes)
    z1 = pool.run("lm", 2, np_p, batches, "adam", True, cfg)[0]
    rep = pool.run("lm", 2, np_p, batches, "adam", False, cfg)[0]
    _close(z1["losses"], rep["losses"])
    for a, b in zip(jax.tree_util.tree_leaves(z1["params"]),
                    jax.tree_util.tree_leaves(rep["params"])):
        _close(a, b)


# ------------------------------------------------------------- compile cache

def test_setup_compile_cache_points_the_kernel_build(tmp_path, monkeypatch):
    """The port's counterpart of the XLA cache: the kernel build's
    directory, first directory wins, the env-gated opt-out, a reset."""
    from deeplearning4j_tpu_torch.ops.cuda import build
    from deeplearning4j_tpu_torch.parallel import compile_cache as cc

    default = build.build_dir()
    cc._reset_for_tests()
    monkeypatch.delenv(cc.ENV_DIR, raising=False)
    assert cc.setup_compile_cache() is None and cc.configured_dir() is None
    monkeypatch.setenv(cc.ENV_ENABLE, "0")
    assert cc.setup_compile_cache(str(tmp_path / "off")) is None
    monkeypatch.delenv(cc.ENV_ENABLE)
    try:
        got = cc.setup_compile_cache(str(tmp_path / "kernels"))
        assert got == str(tmp_path / "kernels") == cc.configured_dir()
        assert build.build_dir() == tmp_path / "kernels"
        assert (tmp_path / "kernels").is_dir()
        assert cc.setup_compile_cache(str(tmp_path / "other")) == got
    finally:
        cc._reset_for_tests()
    assert cc.configured_dir() is None and build.build_dir() == default
