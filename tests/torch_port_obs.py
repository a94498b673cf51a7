"""Per-test isolation of the port's process-wide observability and chaos
state, for the test files of the trainer, checkpoints, resilience and
reload (the repository's conftest resets the JAX package's singletons).

Import :func:`port_obs` into a test module to make it autouse there."""

import pytest

from deeplearning4j_tpu_torch import observability as tobs
from deeplearning4j_tpu_torch.resilience import FAULTS as TFAULTS


@pytest.fixture(autouse=True)
def port_obs(tmp_path):
    """Wipe the port's metrics, tracer and flight recorder after every
    test (and restore the enable flag), point flight-recorder dumps at the
    test's tmp dir while it runs, and disarm the fault injector."""
    old_dump_dir = tobs.FLIGHTREC.dump_dir
    tobs.FLIGHTREC.dump_dir = tmp_path / "flightrec"
    TFAULTS.disarm()
    tobs.METRICS.reset()
    yield
    TFAULTS.disarm()
    tobs.enable()
    tobs.METRICS.reset()
    tobs.TRACER.clear()
    tobs.TRACER.stop_stream()
    tobs.FLIGHTREC.clear()
    tobs.FLIGHTREC.dump_dir = old_dump_dir
