"""The port's CLI, ``python -m deeplearning4j_tpu_torch train|evaluate``,
on the CPU (``--platform cpu``), against the JAX package's CLI."""

import os
import subprocess
import sys
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
    ["scaleout", "--state-dir", "/nonexistent"], ["dryrun", "--devices", "4"],
    ["provision", "--repo-url", "x"]])
def test_multi_device_commands_parse_and_name_the_roadmap_item(argv,
                                                              monkeypatch):
    """scaleout and provision (the host control plane) exit naming their
    roadmap item; dryrun is ported (test_torch_dryrun.py runs it): it
    parses, and on its default platform without a card it raises asking
    for the CPU, as every entry point does."""
    if argv[0] == "dryrun":
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tcli.main(argv)
        return
    with pytest.raises(SystemExit, match="A10.3"):
        tcli.main(argv)


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
