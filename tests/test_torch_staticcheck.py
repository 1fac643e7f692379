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
    """Audit mode: no pragma past the budget (PRAGMA003) and none stale
    (PRAGMA002).  The reference's WIRE001 pragmas on the payload kinds
    that have no protobuf slot answer transport/pb_adapter.py's pairing
    check, so they are live now that the adapter is ported; the gRPC
    transport and the validator host bring the reference's thirteen
    pragmas of theirs (budget 33 -> 46)."""
    _rc, report = _staticcheck("--audit-pragmas")
    assert json.loads(BASELINE.read_text())["pragma_budget"] == 46
    assert report["findings"] == [], report["findings"]
    pb = REPO / "cleisthenes_tpu_torch" / "transport" / "pb_adapter.py"
    assert pb.exists()
