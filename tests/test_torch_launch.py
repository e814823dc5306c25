"""The port's drivers on the CPU: ``repro_torch.launch.train.main`` and
``repro_torch.launch.serve.main`` with ``--smoke --device cpu`` (the card's
runs are ``chip_smoke.py``'s ``train-full`` and ``serve-launch``).

The port draws its own random weights, so these check the drivers' flow
(steps, checkpoints and the restore, requests served, tokens emitted)
rather than numbers against the JAX package's drivers; the steps
themselves are held to the JAX package's in ``test_torch_train_step.py``.
"""
import math

import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch import serve, train  # noqa: E402


@pytest.mark.parametrize("arch,opt", [("smollm-135m", "adamw"),
                                      ("minicpm-2b", "lion")])
def test_train_main_runs_and_resumes(tmp_path, capsys, arch, opt):
    argv = ["--arch", arch, "--smoke", "--batch", "2", "--seq", "16",
            "--device", "cpu", "--ckpt-dir", str(tmp_path), "--ckpt-every",
            "3", "--log-every", "3", "--optimizer", opt]
    out = train.main(argv + ["--steps", "6"])
    assert out["step"] == 6 and len(out["losses"]) == 6
    assert all(math.isfinite(l) for l in out["losses"])
    again = train.main(argv + ["--steps", "9"])
    text = capsys.readouterr().out
    assert "restored from step 6" in text
    assert again["step"] == 9 and len(again["losses"]) == 3
    assert "device=cpu" in text


def test_serve_main_greedy_and_mcts(capsys):
    base = ["--arch", "smollm-135m", "--smoke", "--device", "cpu",
            "--max-new", "3"]
    out = serve.main(base + ["--requests", "3", "--max-batch", "2",
                             "--max-seq", "32"])
    assert out["stats"]["serving/tokens"] == 9    # 3 requests x 3 tokens
    assert [len(t) for t in out["outputs"].values()] == [3, 3, 3]
    got = serve.main(base + ["--mcts", "--mcts-budget", "4",
                             "--prompt-len", "5"])
    assert len(got["tokens"]) == 3
    assert "mcts-decode" in capsys.readouterr().out


def test_serve_main_rejects_whisper():
    with pytest.raises(SystemExit, match="decoder-only"):
        serve.main(["--arch", "whisper-base", "--smoke", "--device", "cpu"])


def test_drivers_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.build("smollm-135m", True, 2, 16, 1e-3, 4)
