"""Roofline analysis of the port on the H100, after ``src/repro/roofline``.

``analysis`` keeps the reference's analytic accounting (``param_counts``,
``forward_flops``, ``step_flops``, ``step_bytes``, the ``Roofline`` record
and ``analyze``) with the same formulas, against the H100 SXM's
data-sheet peaks in place of the reference's constants.

The reference's ``hlo_parse`` reads XLA's compiled text and has no file to
become here. Each of its jobs is done by the port's own code:

* ``collective_stats`` (collective bytes and counts of a compiled step)
  is the counted census of ``perf/collectives.py``: every collective goes
  through ``launch.distributed.collective``, which counts what ran;
* trip-count scaling (XLA counts a ``while`` body once) is not needed: an
  eager run executes every iteration of every loop, and
  ``obs/profile.py`` counts each operation as it runs;
* ``shape_bytes`` and the computation walk serve the reference's FLOP
  attribution, which ``obs/profile.py`` does on aten operations.
"""

from repro_torch.roofline.analysis import (
    HBM_BW,
    HBM_BYTES,
    NETWORK_BW,
    NVLINK_BW,
    PEAK_FLOPS,
    PEAK_FLOPS_F32,
    Roofline,
    analyze,
    forward_flops,
    param_counts,
    peak_flops,
    step_bytes,
    step_flops,
)

__all__ = [
    "HBM_BW", "HBM_BYTES", "NETWORK_BW", "NVLINK_BW", "PEAK_FLOPS", "PEAK_FLOPS_F32",
    "Roofline", "analyze", "forward_flops", "param_counts", "peak_flops", "step_bytes",
    "step_flops",
]
