"""The 95th percentile, over the window's samples, of the time from handing
a sample's ``ReadBatch`` to ``solve`` until its read indices are on the
host (linear between order statistics)."""

import numpy as np


def read(run):
    return float(np.percentile(run.spans, 95)) if run.spans else None
