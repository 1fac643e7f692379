# The reference's tests/test_demo.py, re-pointed at cleisthenes_tpu_torch:
# the host backend ('cpu') where the reference took its default.
"""The demo CLI (cleisthenes_tpu_torch/demo.py) driven in-process.

The demo is the framework's app-facing entry.  These runs pass
``--crypto cpu``: the demo's default crypto is the card's."""

from cleisthenes_tpu_torch import demo


def test_demo_grpc_mode_commits_all(tmp_path):
    rc = demo.main(
        [
            "--crypto", "cpu", "--n", "4", "--txs", "16", "--batch-size", "8",
            "--log-dir", str(tmp_path),
        ]
    )
    assert rc == 0
    # durable logs were written for every node
    assert sum(1 for _ in tmp_path.iterdir()) >= 4


def test_demo_lockstep_mode_commits_all():
    assert demo.main(["--crypto", "cpu", "--n", "4", "--txs", "12", "--mode", "lockstep"]) == 0


def test_demo_lockstep_with_dkg_keys(capsys):
    assert (
        demo.main(
            ["--crypto", "cpu", "--n", "4", "--txs", "8", "--mode", "lockstep", "--dkg"]
        )
        == 0
    )
    # the DKG really ran: its banner is printed and the epoch
    # decrypted under the DKG key set
    out = capsys.readouterr().out
    assert "DKG complete" in out and "SUCCESS" in out


def test_demo_trace_writes_valid_artifact(tmp_path):
    """--trace runs the grpc cluster under the flight recorder and
    writes a tracetool-valid Chrome trace on exit."""
    import pathlib
    import sys

    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
    from tools import tracetool

    out = tmp_path / "demo_trace.json"
    rc = demo.main(
        [
            "--crypto", "cpu", "--n", "4", "--txs", "8", "--batch-size", "8",
            "--log-dir", str(tmp_path / "wal"),
            "--trace", str(out),
        ]
    )
    assert rc == 0
    doc = tracetool.load(str(out))
    assert tracetool.validate(doc) == []
    summary = tracetool.summarize(doc)
    # the gRPC path's own planes showed up: dispatcher queue-depth
    # waves and WAL appends ride the node timelines
    assert summary["events_by_category"].get("transport", 0) > 0
    assert summary["events_by_category"].get("ledger", 0) > 0
    assert summary["events_by_category"].get("epoch", 0) > 0


def test_demo_restart_resumes_from_logs(tmp_path):
    """Second run against the same --log-dir must replay the durable
    batches and keep committing (the restart/recovery surface)."""
    args = [
        "--crypto", "cpu", "--n", "4", "--txs", "8", "--batch-size", "8",
        "--log-dir", str(tmp_path),
    ]
    assert demo.main(args) == 0
    assert demo.main(args) == 0


def test_demo_defaults_to_the_card():
    """Without --crypto the demo runs on the card ('cuda' on device
    'cuda', the port's Config defaults); where there is none it raises
    before any validator starts, and never falls back to the host."""
    import pytest
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    with pytest.raises(RuntimeError, match="needs a GPU"):
        demo.main(["--n", "4", "--txs", "8", "--batch-size", "8"])
