"""The repo's static analyzer (tools/staticcheck) over the port.

ci.sh runs the analyzer over the reference package, the tools and the
tests, against tools/staticcheck/baseline.json and its pragma budget.
The port is held here to the same rules, against its own baseline
(tests/torch_staticcheck_baseline.json: no grandfathered findings, and
a pragma budget equal to the port's pragma count).  Every pragma in the
port is either the reference's own, copied with its line, or justifies
the port's ModEngine.stats timing."""

import json
import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent
BASELINE = REPO / "tests" / "torch_staticcheck_baseline.json"


def _staticcheck(*flags):
    out = subprocess.run(
        [
            sys.executable, "-m", "tools.staticcheck", "cleisthenes_tpu_torch",
            "--baseline", str(BASELINE), "--json", *flags,
        ],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    return out.returncode, json.loads(out.stdout)


def test_port_has_no_findings():
    rc, report = _staticcheck()
    assert report["findings"] == [], report["findings"]
    assert report["baselined"] == [] and rc == 0
    assert report["summary"]["files"] >= 66


def test_port_pragmas_within_budget_and_live():
    """Audit mode: no pragma past the budget (PRAGMA003), and none stale
    (PRAGMA002) except the reference's WIRE001 pragmas on the payload
    kinds that have no protobuf slot.  Those pragmas answer the pb
    adapter's pairing check, which has nothing to pair with until
    transport/pb_adapter.py is ported."""
    _rc, report = _staticcheck("--audit-pragmas")
    assert json.loads(BASELINE.read_text())["pragma_budget"] == 33
    wire_stale = [
        f for f in report["findings"]
        if f["rule"] == "PRAGMA002"
        and f["path"] == "cleisthenes_tpu_torch/transport/message.py"
        and "allow[WIRE001]" in f["message"]
    ]
    others = [f for f in report["findings"] if f not in wire_stale]
    assert others == [], others
    assert len(wire_stale) == 9
    pb = REPO / "cleisthenes_tpu_torch" / "transport" / "pb_adapter.py"
    assert not pb.exists(), "pb_adapter.py is ported: these pragmas are live"
