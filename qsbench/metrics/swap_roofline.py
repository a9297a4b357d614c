"""swap_roofline: the bit-pair steps' least time (``passes.py``: the state
read and written once at the HBM bandwidth, each step) over their time in
the device spans around ``ops.plan.apply_bitpair_step``, percent. In the
QFT cells every bit-pair step is an exact swap."""

from pathlib import Path

from qsbench.passes import listed_config, pass_roofline
from qsbench.reduce import PLAN

SPANS = {f"{PLAN}:apply_bitpair_step": "device"}
ROOT = Path(__file__).resolve().parents[2]


def read(ctx):
    return pass_roofline(ctx, "apply_bitpair_step",
                         listed_config(ROOT, "swap_roofline"))
