"""The port's provisioning (``parallel.provision``) and the scaleout Kill
CLI, after ``tests/test_provision.py``.

The port aims the reference's bring-up at H100 hosts (the module's
docstring lists each difference): ``h100-<N>`` cards, eight to an
``a3-highgpu-8g`` host, Compute Engine instances ``<name>-<i>``, one rank
a card with ``MASTER_ADDR``/``MASTER_PORT``/``WORLD_SIZE``/``RANK``.
Nothing reaches a cloud: the ``apply`` tests run a stub ``gcloud`` on
``PATH`` that logs its argv (as the reference's do), and the launch
command itself runs here against stub ``hostname`` and ``python``
commands, which shows each card's rank.
"""

import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest

from deeplearning4j_tpu.parallel.provision import (
    PodSliceProvisioner as JProvisioner, PodSliceSpec as JSpec)
from deeplearning4j_tpu_torch.parallel.procstate import FileStateTracker
from deeplearning4j_tpu_torch.parallel.provision import (
    PodSliceProvisioner, PodSliceSpec)
from torch_port_obs import port_obs  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parents[1]
ENV = {**os.environ, "OMP_NUM_THREADS": "1"}
TRAIN = "-m deeplearning4j_tpu_torch train"


def _cli(*argv, env=None, timeout=120):
    return subprocess.run(
        [sys.executable, "-m", "deeplearning4j_tpu_torch", *argv],
        capture_output=True, text=True, timeout=timeout, env=env or ENV,
        cwd=REPO)


def test_cluster_spec_geometry():
    s = PodSliceSpec(accelerator_type="h100-64")
    assert s.n_chips == 64 and s.n_hosts == 8      # eight cards a host
    assert s.machine_type == "a3-highgpu-8g"
    assert s.host_names == [f"dl4j-h100-{i}" for i in range(8)]
    assert PodSliceSpec(accelerator_type="h100-16").n_hosts == 2
    small = PodSliceSpec(accelerator_type="h100-4")
    assert (small.n_hosts, small.chips_per_host, small.machine_type) == (
        1, 4, "a3-highgpu-4g")


def test_tpu_accelerator_types_are_refused():
    """The reference's TPU types name no H100 cluster: the port refuses
    them instead of guessing a geometry."""
    for t in ("v5litepod-64", "v4-8", "v5p-128"):
        assert JSpec(accelerator_type=t).n_chips > 0
        with pytest.raises(ValueError, match="h100"):
            PodSliceSpec(accelerator_type=t).n_chips


def test_create_and_launch_commands():
    spec = PodSliceSpec(name="c1", accelerator_type="h100-16",
                        zone="us-central1-a", spot=True, project="p")
    prov = PodSliceProvisioner(spec)
    create = prov.create_command()
    assert create[:6] == ["gcloud", "compute", "instances", "create",
                          "c1-0", "c1-1"]
    assert "--machine-type=a3-highgpu-8g" in create
    assert "--provisioning-model=SPOT" in create
    assert "--project=p" in create

    env = prov.launch_env(3, "10.0.0.2")
    assert env == {"MASTER_ADDR": "10.0.0.2", "MASTER_PORT": "29500",
                   "WORLD_SIZE": "16", "RANK": "3"}

    launch = prov.launch_command(TRAIN, "$COORD")
    assert "MASTER_ADDR=$COORD MASTER_PORT=29500 WORLD_SIZE=16" in launch
    assert "RANK=$((H * 8 + L)) CUDA_VISIBLE_DEVICES=$L" in launch
    assert "hostname" in launch                     # per-host index
    assert "python -m deeplearning4j_tpu_torch train" in launch
    boot = prov.bootstrap_command("https://example.com/r.git")
    assert "pip install -U torch numpy" in boot and "jax" not in boot
    ssh = prov.ssh_all_command("echo hi")
    assert ssh[0] == "bash" and ssh[-1] == "echo hi"
    assert "c1-0 c1-1" in ssh[2]


def test_launch_command_starts_one_rank_a_card(tmp_path):
    """The launch command run on host 1 of a 16-card cluster (stub
    ``hostname`` and ``python``): eight processes, ranks 8-15, each on its
    own card, with the rendezvous environment ``initialize_multihost``
    reads."""
    bindir = tmp_path / "bin"
    bindir.mkdir()
    log = tmp_path / "ranks.log"
    (bindir / "hostname").write_text("#!/bin/sh\necho c1-1\n")
    (bindir / "python").write_text(
        "#!/bin/sh\n"
        f'echo "$MASTER_ADDR $MASTER_PORT $WORLD_SIZE $RANK '
        f'$CUDA_VISIBLE_DEVICES $*" >> {log}\n')
    for f in bindir.iterdir():
        f.chmod(0o755)
    prov = PodSliceProvisioner(PodSliceSpec(name="c1",
                                            accelerator_type="h100-16"))
    cmd = prov.launch_command(TRAIN, "10.0.0.2", workdir=str(tmp_path))
    subprocess.run(["bash", "-c", cmd], check=True, timeout=60,
                   env={**os.environ, "PATH": f"{bindir}:{os.environ['PATH']}"})
    rows = sorted((ln.split() for ln in log.read_text().splitlines()),
                  key=lambda r: int(r[3]))
    assert [r[3] for r in rows] == [str(i) for i in range(8, 16)]
    assert [r[4] for r in rows] == [str(i) for i in range(8)]
    assert {tuple(r[:3]) for r in rows} == {("10.0.0.2", "29500", "16")}
    assert {" ".join(r[5:]) for r in rows} == {TRAIN}


def test_render_script_is_wellformed(tmp_path):
    prov = PodSliceProvisioner(PodSliceSpec(accelerator_type="h100-16"))
    path = prov.write_script(tmp_path / "up.sh", "https://example.com/r.git",
                             TRAIN)
    text = path.read_text()
    assert text.startswith("#!/usr/bin/env bash")
    assert "set -euo pipefail" in text
    assert "instances create dl4j-h100-0 dl4j-h100-1" in text
    # remote index lookup and rank arithmetic escaped for the outer shell;
    # the coordinator expands there
    assert "\\$(hostname" in text and "\\$((H * 8 + L))" in text
    assert "MASTER_ADDR=$COORD" in text
    assert os.access(path, os.X_OK)
    # the script parses as shell
    subprocess.run(["bash", "-n", str(path)], check=True)


def test_cli_scaleout_kill(tmp_path):
    state = tmp_path / "state"
    FileStateTracker(state)          # create the layout
    p = _cli("scaleout", "-t", "kill", "--state-dir", str(state))
    assert p.returncode == 0, p.stderr[-800:]
    assert FileStateTracker(state).is_done()


def test_kill_stops_running_master(tmp_path):
    """A kill issued while a master runs makes the whole run wind down
    (Kill.java behavior)."""
    from deeplearning4j_tpu_torch.parallel.procrunner import (
        ProcessDistributedRunner)
    from deeplearning4j_tpu_torch.parallel.scaleout import (
        CollectionJobIterator)

    state = tmp_path / "state"
    runner = ProcessDistributedRunner(
        CollectionJobIterator(["a b", "c"]),
        "deeplearning4j_tpu_torch.parallel.performers:WordCountPerformer",
        state_dir=state, n_workers=1, worker_env={"OMP_NUM_THREADS": "1"})

    killer = threading.Thread(
        target=lambda: (time.sleep(1.5), FileStateTracker(state).finish()),
        daemon=True)
    killer.start()
    t0 = time.time()
    runner.run(max_wall_s=60.0)
    # jobs drain quickly; kill (or natural finish) must not hang to the wall
    assert time.time() - t0 < 50.0
    assert FileStateTracker(state).is_done()
    killer.join(timeout=5.0)


def _stub_gcloud(tmp_path):
    """A fake gcloud on PATH that logs argv and answers `describe` with an
    IP — lets apply()/teardown() integration-test without a cloud."""
    bindir = tmp_path / "bin"
    bindir.mkdir(exist_ok=True)
    log = tmp_path / "gcloud.log"
    stub = bindir / "gcloud"
    stub.write_text(
        "#!/usr/bin/env bash\n"
        f'echo "$@" >> {log}\n'
        'for a in "$@"; do\n'
        '  if [ "$a" = "describe" ]; then echo 10.1.2.3; fi\n'
        "done\n")
    stub.chmod(0o755)
    return bindir, log


def test_apply_dry_run_is_default_and_runs_nothing(tmp_path, monkeypatch):
    bindir, log = _stub_gcloud(tmp_path)
    monkeypatch.setenv("PATH", f"{bindir}:{os.environ['PATH']}")
    prov = PodSliceProvisioner(PodSliceSpec(accelerator_type="h100-16"))
    records = prov.apply("https://example.com/r.git", TRAIN)
    ref = JProvisioner(JSpec(accelerator_type="v5litepod-8")).apply(
        "https://example.com/r.git", "-m deeplearning4j_tpu train")
    assert [r["step"] for r in records] == [r["step"] for r in ref] == [
        "create", "bootstrap", "resolve_coordinator", "launch"]
    assert [sorted(r) for r in records] == [sorted(r) for r in ref]
    assert all(r["rc"] is None for r in records)     # nothing executed
    assert "MASTER_ADDR=$COORD" in records[-1]["cmd"][-1]
    assert not log.exists()


def test_apply_executes_against_stub_gcloud(tmp_path, monkeypatch):
    """--apply parity with ClusterSetup.java:24: the sequence actually
    executes (create -> bootstrap -> describe -> launch) with one ssh a
    host, the resolved coordinator IP feeds the launch env, and --kill
    tears down."""
    bindir, log = _stub_gcloud(tmp_path)
    monkeypatch.setenv("PATH", f"{bindir}:{os.environ['PATH']}")

    prov = PodSliceProvisioner(PodSliceSpec(
        name="s8", accelerator_type="h100-16", zone="us-central1-a"))
    records = prov.apply("https://example.com/r.git", TRAIN, dry_run=False)
    assert [r["rc"] for r in records] == [0, 0, 0, 0]
    logged = log.read_text()
    assert "create s8-0 s8-1" in logged and "delete" not in logged
    # bootstrap + launch, on each of the two hosts
    assert sorted(ln.split()[2] for ln in logged.splitlines()
                  if ln.startswith("compute ssh")) == ["s8-0", "s8-0",
                                                       "s8-1", "s8-1"]
    assert "describe s8-0" in logged
    launch = records[-1]["cmd"][-1]
    assert "MASTER_ADDR=10.1.2.3 MASTER_PORT=29500" in launch

    rec = prov.teardown(dry_run=False)
    assert rec["rc"] == 0
    assert "delete s8-0 s8-1" in log.read_text()


def test_a_failing_host_fails_the_step(tmp_path, monkeypatch):
    """One host's ssh failing fails the whole fan-out (the bootstrap must
    not be reported done on a host where it failed)."""
    bindir = tmp_path / "bin"
    bindir.mkdir()
    stub = bindir / "gcloud"
    stub.write_text('#!/usr/bin/env bash\n'
                    'case "$*" in *"ssh s8-1"*) exit 7;; esac\nexit 0\n')
    stub.chmod(0o755)
    monkeypatch.setenv("PATH", f"{bindir}:{os.environ['PATH']}")
    prov = PodSliceProvisioner(PodSliceSpec(name="s8",
                                            accelerator_type="h100-16"))
    with pytest.raises(RuntimeError, match="'bootstrap' failed rc=1"):
        prov.apply("https://example.com/r.git", TRAIN, dry_run=False)


def test_cli_provision_apply_and_kill_with_stub(tmp_path):
    bindir, log = _stub_gcloud(tmp_path)
    env = {**ENV, "PATH": f"{bindir}:{os.environ['PATH']}"}
    p = _cli("provision", "--name", "sX", "--accelerator-type", "h100-8",
             "--repo-url", "https://example.com/r.git", "--apply", env=env)
    assert p.returncode == 0, p.stderr[-800:]
    assert "create sX-0" in log.read_text()
    steps = [json.loads(ln)["step"] for ln in p.stdout.splitlines()]
    assert steps == ["create", "bootstrap", "resolve_coordinator", "launch"]

    p = _cli("provision", "--name", "sX", "--kill", "--apply", env=env)
    assert p.returncode == 0, p.stderr[-800:]
    assert "delete sX-0" in log.read_text()


def test_cli_provision_kill_dry_run_executes_nothing(tmp_path):
    """--kill without --apply must only PRINT the delete command; a plain
    provision renders the script."""
    bindir, log = _stub_gcloud(tmp_path)
    env = {**ENV, "PATH": f"{bindir}:{os.environ['PATH']}"}
    p = _cli("provision", "--name", "sY", "--kill", env=env)
    assert p.returncode == 0, p.stderr[-800:]
    assert "delete" in p.stdout and not log.exists()
    p = _cli("provision", "--repo-url", "https://example.com/r.git",
             "--out", str(tmp_path / "up.sh"), env=env)
    assert p.returncode == 0, p.stderr[-800:]
    assert "a3-highgpu-8g" in (tmp_path / "up.sh").read_text()
    assert not log.exists()


def test_apply_timeout_names_step_and_keeps_audit_trail(tmp_path, monkeypatch):
    """A hung gcloud must surface as a RuntimeError naming the step, with
    the records-so-far attached — a half-created cluster keeps its audit
    trail so the caller can tear down exactly what was attempted."""
    bindir = tmp_path / "bin"
    bindir.mkdir(exist_ok=True)
    stub = bindir / "gcloud"
    stub.write_text("#!/usr/bin/env bash\nsleep 5\n")
    stub.chmod(0o755)
    monkeypatch.setenv("PATH", f"{bindir}:{os.environ['PATH']}")

    prov = PodSliceProvisioner(PodSliceSpec(
        name="s8", accelerator_type="h100-8", zone="us-central1-a"))
    with pytest.raises(RuntimeError, match="'create' timed out") as ei:
        prov.apply("https://example.com/r.git", TRAIN,
                   dry_run=False, timeout_s=0.3)
    err = ei.value
    assert isinstance(err.__cause__, subprocess.TimeoutExpired)
    assert [r["step"] for r in err.records] == ["create"]
    assert err.records[0]["rc"] is None          # never finished
    assert "teardown" in str(err)
