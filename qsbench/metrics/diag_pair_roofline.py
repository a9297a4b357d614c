"""diag_pair_roofline: the pair-diagonal steps' least time (``passes.py``:
the state read and written once at the HBM bandwidth, each step) over
their time in the device spans around ``ops.plan.apply_diag_pair_step``,
percent."""

from pathlib import Path

from qsbench.passes import listed_config, pass_roofline
from qsbench.reduce import PLAN

SPANS = {f"{PLAN}:apply_diag_pair_step": "device"}
ROOT = Path(__file__).resolve().parents[2]


def read(ctx):
    return pass_roofline(ctx, "apply_diag_pair_step",
                         listed_config(ROOT, "diag_pair_roofline"))
