"""repro_torch's examples run on ``--device cpu`` at their smallest size:
the quickstart trains (the loss falls) and decodes, ``serve_demo`` serves
its ten requests, ``dse_sharding`` runs one loop iteration on the 2x4 fake
mesh, and ``train_100m``'s ``tiny`` preset trains and then resumes from
its own last checkpoint with nothing left to do."""
import pytest
import torch

from repro_torch.examples import dse_sharding, quickstart, serve_demo, train_100m


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this file's small models, so that under the
    suite's parallel workers they do not oversubscribe the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_quickstart_trains_and_decodes(capsys):
    out = quickstart.main(["--device", "cpu"])
    assert out["last_loss"] < out["first_loss"]
    assert len(out["generated"]) == 8
    assert "improved" in capsys.readouterr().out


def test_serve_demo_serves_every_request():
    s = serve_demo.main(["--device", "cpu"])
    assert (s["requests"], s["tokens"]) == (10, 120)
    assert s["decode_steps"] == 3 * 11  # equal max_new: three waves of 11 steps


def test_dse_sharding_runs_the_loop():
    out = dse_sharding.main(["--device", "cpu", "--iterations", "1", "--budget", "1"])
    assert out["designs"] >= 2  # the expert baseline and a proposal
    assert out["improvement"] >= 1.0


def test_train_100m_tiny_preset_trains_and_resumes(tmp_path, capsys):
    argv = ["--device", "cpu", "--preset", "tiny", "--ckpt", str(tmp_path)]
    out = train_100m.main(argv)
    assert out["final_step"] == 2 and len(out["history"]) == 2
    assert all(h["loss"] > 0 for h in out["history"])
    again = train_100m.main(argv)
    assert again["final_step"] == 2 and again["history"] == []
    assert "resuming from committed checkpoint at step 2" in capsys.readouterr().out
