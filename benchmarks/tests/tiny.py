"""Small sizes at which the CPU tests run the cells: the same code paths
(int8 through K6's plain version, K3's plain version past 128 tokens),
widths and frames cut so that a run takes seconds. A configuration's test
sizes are ``configs/<config>.tiny.json`` and a mix's
``traffic/<mix>.tiny.json``: keys that replace those of the configuration
or the mix, found by name like the rest of a cell."""
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

SEED = 2**31 + 17


def overrides(cell: str):
    """(config overrides, mix overrides) of ``cell`` at the test size."""
    import harness

    wl = harness.load_json(BENCH / "workloads" / f"{cell}.json")
    return (harness.load_json(BENCH / "configs" / f"{wl['config']}.tiny.json"),
            harness.load_json(BENCH / "traffic" / f"{wl['traffic']}.tiny.json"))
