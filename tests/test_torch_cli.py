"""The port's CLI, ``python -m deeplearning4j_tpu_torch train|evaluate``,
on the CPU (``--platform cpu``), against the JAX package's CLI; and its
host commands, ``scaleout`` (master, worker and kill roles over the file
state plane) and ``provision`` (``test_torch_provision.py`` runs it
against a stub ``gcloud``), which touch no device."""

import os
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from deeplearning4j_tpu import __main__ as jcli
from deeplearning4j_tpu_torch import __main__ as tcli

ROOT = Path(__file__).resolve().parents[1]


def _stats(out: str) -> str:
    """The Evaluation.stats() block of a CLI's output."""
    lines = out.splitlines()
    start = lines.index(
        "==========================Scores==========================")
    return "\n".join(l for l in lines[start:] if not l.startswith("model "))


@pytest.mark.parametrize("where", ["after", "before"])
def test_train_then_evaluate_on_iris(tmp_path, capsys, where):
    out = tmp_path / "iris.pkl"
    args = ["train", "--dataset", "iris", "--iterations", "30",
            "--out", str(out)]
    plat = ["--platform", "cpu"]
    assert tcli.main(args + plat if where == "after" else plat + args) == 0
    trained = capsys.readouterr().out
    assert f"model saved to {out}" in trained
    assert tcli.main(["evaluate", str(out), "--dataset", "iris",
                      "--platform", "cpu"]) == 0
    evaluated = capsys.readouterr().out
    assert _stats(evaluated) == _stats(trained)
    f1 = float(next(l for l in trained.splitlines() if "F1 Score" in l)
               .split()[-1])
    assert f1 > 0.8


def test_each_cli_evaluates_the_others_save_file(tmp_path, capsys):
    ref, port = tmp_path / "ref.pkl", tmp_path / "port.pkl"
    assert jcli.main(["--platform", "cpu", "train", "--dataset", "iris",
                      "--iterations", "10", "--out", str(ref)]) == 0
    assert tcli.main(["train", "--platform", "cpu", "--dataset", "iris",
                      "--iterations", "10", "--out", str(port)]) == 0
    capsys.readouterr()
    for path in (ref, port):
        assert jcli.main(["--platform", "cpu", "evaluate", str(path)]) == 0
        j = capsys.readouterr().out
        assert tcli.main(["evaluate", str(path), "--platform", "cpu"]) == 0
        t = capsys.readouterr().out
        assert _stats(t) == _stats(j)


def test_train_from_a_json_conf(tmp_path, capsys):
    from deeplearning4j_tpu_torch.models import zoo
    conf = zoo.mlp(4, 3, hidden=(6,), num_iterations=5, device="cpu").conf
    p = tmp_path / "conf.json"
    p.write_text(conf.to_json())
    assert tcli.main(["train", "-jsonpath", str(p), "--platform", "cpu"]) == 0
    assert "F1 Score" in capsys.readouterr().out
    assert tcli.main(["train", "-json", conf.to_json(),
                      "--platform", "cpu"]) == 0


def test_usage_errors(capsys):
    with pytest.raises(SystemExit) as e:
        tcli.main(["train", "--no-such-flag", "--platform", "cpu"])
    assert e.value.code == 2
    with pytest.raises(SystemExit, match="unknown dataset"):
        tcli.main(["train", "--dataset", "cifar", "--platform", "cpu"])
    with pytest.raises(SystemExit, match="unknown --model"):
        tcli.main(["train", "--model", "resnet", "--platform", "cpu"])
    with pytest.raises(SystemExit) as e:
        tcli.main([])
    assert e.value.code == 2


@pytest.mark.parametrize("argv", [
    pytest.param(["dryrun", "--devices", "4"], id="argv1")])
def test_multi_device_commands_parse_and_name_the_roadmap_item(argv,
                                                              monkeypatch):
    """dryrun is ported (test_torch_dryrun.py runs it): it parses, and on
    its default platform without a card it raises asking for the CPU, as
    every entry point does.  (scaleout and provision, which named their
    roadmap item here before they ran, are held below.)"""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcli.main(argv)


def _scaleout_cli(*argv, timeout=120):
    return subprocess.run(
        [sys.executable, "-m", "deeplearning4j_tpu_torch", "scaleout", *argv],
        cwd=ROOT, capture_output=True, text=True, timeout=timeout,
        env={**os.environ, "OMP_NUM_THREADS": "1"})


def test_cli_scaleout_word_count(tmp_path):
    """The reference CLI test's case: a master with two worker processes
    counts the words of a jobs file; the count equals the reference's
    runner's on the same lines."""
    import json
    from collections import Counter

    from deeplearning4j_tpu.parallel import performers as jperf
    from deeplearning4j_tpu.parallel import scaleout as jso

    jobs = tmp_path / "jobs.txt"
    jobs.write_text("a b a\nb c\n")
    p = _scaleout_cli("--state-dir", str(tmp_path / "state"),
                      "--jobs", str(jobs), "--workers", "2")
    assert p.returncode == 0, p.stderr[-1500:]
    assert '"a": 2' in p.stdout, p.stdout
    got = Counter(json.loads(p.stdout.strip().splitlines()[-1]))
    want = jso.DistributedRunner(
        jso.CollectionJobIterator(["a b a", "b c"]),
        jperf.WordCountPerformer, n_workers=2,
        router_cls=jperf.WordCountRouter).run(max_wall_s=60.0)
    assert got == want


def test_cli_scaleout_worker_joins_a_state_dir(tmp_path):
    """``-t worker`` joins an existing state directory as the given
    worker, performs its job through the default (the port's) performer,
    and exits when ``-t kill`` raises DONE."""
    from deeplearning4j_tpu_torch.parallel.procstate import FileStateTracker
    from deeplearning4j_tpu_torch.parallel.scaleout import Job

    state = tmp_path / "state"
    t = FileStateTracker(state)
    t.add_worker("w7")
    t.add_job(Job(work="x y x", worker_id="w7"))
    proc = subprocess.Popen(
        [sys.executable, "-m", "deeplearning4j_tpu_torch", "scaleout",
         "-t", "worker", "--state-dir", str(state), "--worker-id", "w7"],
        cwd=ROOT, env={**os.environ, "OMP_NUM_THREADS": "1"},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        deadline = time.time() + 60.0
        while "w7" not in t.updates() and time.time() < deadline:
            time.sleep(0.05)
        assert t.updates()["w7"] == {"x": 2, "y": 1}
        assert t.job_for("w7") is None
        k = _scaleout_cli("-t", "kill", "--state-dir", str(state))
        assert k.returncode == 0 and "kill signalled" in k.stdout
        assert proc.wait(timeout=60) == 0
    finally:
        proc.kill()
        proc.communicate(timeout=30)


def test_cli_host_commands_need_no_card(tmp_path, monkeypatch, capsys):
    """scaleout and provision touch no device: without a card they run
    (the train/evaluate/dryrun commands ask for --platform cpu); the
    master role needs --jobs; the performer default is the port's."""
    from deeplearning4j_tpu_torch.parallel.procstate import FileStateTracker

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--jobs is required"):
        tcli.main(["scaleout", "--state-dir", str(tmp_path / "s")])
    assert tcli.main(["scaleout", "-t", "kill", "--state-dir",
                      str(tmp_path / "s")]) == 0
    assert FileStateTracker(tmp_path / "s").is_done()
    assert tcli.main(["provision", "--repo-url", "x"]) == 0
    out = capsys.readouterr().out
    assert "python -m deeplearning4j_tpu_torch train" in out
    assert "a3-highgpu-8g" in out
    with pytest.raises(SystemExit, match="--repo-url is required"):
        tcli.main(["provision"])


def test_default_platform_is_the_card_and_raises_without_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcli.main(["train", "--dataset", "iris"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcli.main(["evaluate", "whatever.pkl"])


def test_python_dash_m_runs_the_cli(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    r = subprocess.run(
        [sys.executable, "-m", "deeplearning4j_tpu_torch", "train",
         "--platform", "cpu", "--dataset", "iris", "--iterations", "5"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "F1 Score" in r.stdout
