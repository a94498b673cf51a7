"""The port's ``Driver`` (``parallel.driver``) against the JAX package's,
after ``tests/test_driver.py``.

The problem is the reference test's: a least-squares fit of
``w_true = [1, -2, 0.5]`` on 64 JAX-drawn rows in batches of 8, SGD with
momentum.  The reference drives it over its 8-device CPU mesh, the port
over its one-rank world on the CPU (the same global batches and mean
loss); params and batches cross as numpy (``models.convert``).  Held:
the losses of every step within 1e-5 of the reference's (float32 sums in
another order, through 80 momentum steps), checkpoints written by either
package resumed by the other to the same losses, the supervised run
(``retry_policy``) under an injected step fault equal to the un-faulted
run, and the status server answering during the run.
"""

import json
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.optimize import transforms as JT
from deeplearning4j_tpu.parallel.driver import Driver as JDriver
from deeplearning4j_tpu.parallel.mesh import MeshSpec as JMeshSpec
from deeplearning4j_tpu_torch.models.convert import params_from_numpy
from deeplearning4j_tpu_torch.optimize import transforms as TT
from deeplearning4j_tpu_torch.parallel import Driver, MeshSpec
from deeplearning4j_tpu_torch.parallel.mesh import rank_devices
from deeplearning4j_tpu_torch.resilience import (FaultSpec, RetryPolicy,
                                                 inject_faults)
from torch_port_obs import port_obs  # noqa: F401  (autouse)

#: the port's losses against the reference's, each step (float32)
TOL_LOSS = 1e-5


class _Batch:
    def __init__(self, x, y):
        self.features, self.labels = x, y


def _problem():
    """The reference test's problem, as numpy."""
    w_true = jnp.asarray([1.0, -2.0, 0.5])
    x = jax.random.normal(jax.random.key(0), (64, 3))
    y = x @ w_true
    x, y = np.asarray(x), np.asarray(y)
    batches = [_Batch(x[i * 8:(i + 1) * 8], y[i * 8:(i + 1) * 8])
               for i in range(8)]
    return {"w": np.zeros(3, np.float32)}, batches, np.asarray(w_true)


def _jloss(p, xb, yb, key=None):
    return jnp.mean((xb @ p["w"] - yb) ** 2)


def _tloss(p, xb, yb, gen=None):
    return ((xb @ p["w"] - yb) ** 2).mean()


def _jtx():
    return JT.chain(JT.momentum(0.9), JT.sgd_lr(5e-2))


def _ttx():
    return TT.chain(TT.momentum(0.9), TT.sgd_lr(5e-2))


def _port_driver(**kw):
    return Driver(_tloss, _ttx(), device="cpu", **kw)


def _ref_driver(**kw):
    return JDriver(_jloss, _jtx(), mesh_spec=JMeshSpec(dp=8), **kw)


def test_driver_trains_checkpoints_and_serves_status(tmp_path):
    params, batches, w_true = _problem()
    driver = _port_driver(checkpoint_dir=tmp_path / "ckpt",
                          checkpoint_every=4, status_port=0)
    answers = []

    class Polled(list):
        """The batch stream, asking the status server at each pass."""

        def __iter__(self):
            base = f"http://127.0.0.1:{driver.status_server.port}"
            answers.append([json.loads(urllib.request.urlopen(
                base + path, timeout=10).read())
                for path in ("/healthz", "/status")])
            return super().__iter__()

    try:
        state, losses = driver.run(params_from_numpy(params, "cpu"),
                                   Polled(batches), epochs=10)
        assert losses[-1] < losses[0] * 0.1
        w = driver.final_params(state)["w"].numpy()
        np.testing.assert_allclose(w, w_true, atol=0.2)
        assert driver.checkpoint_manager.latest_step() == 80
        # observability wired through
        metrics = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{driver.status_server.port}/metrics",
            timeout=10).read())
        assert metrics["counters"]["driver.steps"] >= len(losses)
        assert len(answers) == 10 and all(
            a == [{"ok": True}, {}] for a in answers)
    finally:
        driver.close()

    ref = _ref_driver()
    _, want = ref.run(params, batches, epochs=10)
    assert len(losses) == len(want) == 80
    np.testing.assert_allclose(losses, want, rtol=0, atol=TOL_LOSS)


def test_driver_resumes_from_checkpoint(tmp_path):
    params, batches, _ = _problem()
    tp = params_from_numpy(params, "cpu")
    d1 = _port_driver(checkpoint_dir=tmp_path / "ckpt", checkpoint_every=2)
    s1, _ = d1.run(tp, batches, epochs=1)

    # a fresh driver resumes at the saved step, not from scratch
    d2 = _port_driver(checkpoint_dir=tmp_path / "ckpt")
    s2, losses2 = d2.run(tp, batches, epochs=1)
    assert s2.step == s1.step
    assert losses2 == []             # nothing left to do at the same epoch count

    # stopped at step 4, resumed over the whole stream: the next losses
    # are the uninterrupted run's
    _, whole = _port_driver().run(tp, batches, epochs=1)
    _port_driver(checkpoint_dir=tmp_path / "half",
                 checkpoint_every=4).run(tp, batches[:4], epochs=1)
    s3, rest = _port_driver(checkpoint_dir=tmp_path / "half").run(
        tp, batches, epochs=1)
    assert s3.step == 8 and rest == whole[4:]


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_driver_checkpoint_resumes_in_the_other_package(tmp_path, writer):
    """Four steps by one package's Driver, the other four by the other
    package's from that checkpoint: the same losses as either package's
    uninterrupted run, within TOL_LOSS."""
    params, batches, _ = _problem()
    tp = params_from_numpy(params, "cpu")
    ck = tmp_path / "ckpt"
    if writer == "reference":
        _ref_driver(checkpoint_dir=ck, checkpoint_every=4).run(
            params, batches[:4])
        s, rest = _port_driver(checkpoint_dir=ck).run(tp, batches)
    else:
        _port_driver(checkpoint_dir=ck, checkpoint_every=4).run(
            tp, batches[:4])
        s, rest = _ref_driver(checkpoint_dir=ck).run(params, batches)
    assert s.step == 8 and len(rest) == 4
    _, whole = _ref_driver().run(params, batches)
    np.testing.assert_allclose(rest, whole[4:], rtol=0, atol=TOL_LOSS)


def test_supervised_driver_recovers_from_a_step_fault(tmp_path):
    """``retry_policy``: a transient fault at step 5 rolls back to the
    step-4 checkpoint and replays; the run ends with the un-faulted run's
    losses (those of the attempt that completed: steps 5-16) and its
    params (the same program, bit for bit), and the fault was seen."""
    params, batches, _ = _problem()
    tp = params_from_numpy(params, "cpu")
    d0 = _port_driver()
    s0, want = d0.run(tp, batches, epochs=2)
    with pytest.raises(ValueError, match="requires checkpoint_dir"):
        _port_driver(retry_policy=RetryPolicy())
    d = _port_driver(checkpoint_dir=tmp_path / "ck", checkpoint_every=4,
                     retry_policy=RetryPolicy(max_attempts=3,
                                              backoff_base_s=0.0))
    with inject_faults(FaultSpec("train.step", at_step=5)):
        state, got = d.run(tp, batches, epochs=2)
    assert state.step == 16 and got == want[4:]
    assert torch.equal(d.final_params(state)["w"], d0.final_params(s0)["w"])
    from deeplearning4j_tpu_torch.observability import METRICS
    assert METRICS.snapshot()["counters"]["resilience.retries"] >= 1


def test_driver_mesh_spans_the_world():
    """``mesh_spec=None`` and a wildcard axis take every rank of the world
    (one without a process group); a spec the world cannot fill raises,
    as the reference's does on too few devices."""
    assert _port_driver().mesh.devices.size == len(rank_devices()) == 1
    assert _port_driver(mesh_spec=MeshSpec(dp=-1)).mesh.devices.size == 1
    with pytest.raises(ValueError):
        _port_driver(mesh_spec=MeshSpec(tp=2))


def test_driver_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Driver(_tloss, _ttx())


def test_inverted_index_save_load_across_packages(tmp_path):
    """The reference test file's third case (the inverted index's disk
    persistence), with the port's index reading the reference's file."""
    from deeplearning4j_tpu.text.index import InvertedIndex as JIndex
    from deeplearning4j_tpu_torch.text.index import InvertedIndex

    idx = JIndex()
    idx.add_doc("the quick brown fox", label="a")
    idx.add_doc("the lazy dog", label="b")
    idx.save(tmp_path / "corpus.idx.gz")

    idx2 = InvertedIndex.load(tmp_path / "corpus.idx.gz")
    assert idx2.num_documents() == 2
    assert idx2.label(1) == "b"
    assert idx2.documents_for("the") == [0, 1]
    assert idx2.search("quick fox")[0][0] == 0
    assert idx2.all_docs() == idx.all_docs()
