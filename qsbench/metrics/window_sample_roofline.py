"""window_sample_roofline: the window samples' least time (``windows.py``:
the state read once at the HBM bandwidth, each sample) over their time in
the device spans around ``ops.monomial_traj._sample_axes``, percent."""

from pathlib import Path

from qsbench.passes import listed_config
from qsbench.windows import MONO, least_sample_s

SPANS = {f"{MONO}:_sample_axes": "device"}
ROOT = Path(__file__).resolve().parents[2]


def read(ctx):
    spans = ctx.spans_named("_sample_axes")
    if not spans:
        return None
    spent = sum(s.end - s.start for s in spans)
    config = listed_config(ROOT, "window_sample_roofline")
    return 100.0 * len(spans) * least_sample_s(config) / spent
