"""Per-device memory accounting of a step, after ``src/repro/perf/memory.py``.

On the card the peak is measured: ``torch.cuda.max_memory_allocated``
after ``reset_peak_memory_stats`` around the measured calls (source
``"cuda_peak"``). On the CPU only the input trees' bytes are known
(source ``"tree_bytes"``). XLA's ``memory_analysis`` buffer breakdown
(``compiled_memory``: output, temp, alias and code bytes) has no eager
counterpart; those fields stay None.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from repro_torch import tree as tu

#: how the numbers were obtained
SOURCE_CUDA_PEAK = "cuda_peak"
SOURCE_TREE = "tree_bytes"


@dataclasses.dataclass(frozen=True)
class MemoryStats:
    """Per-device step memory (bytes), in the JAX record's fields."""

    argument_bytes: int
    output_bytes: int
    temp_bytes: Optional[int]
    generated_code_bytes: Optional[int]
    alias_bytes: Optional[int]
    peak_bytes: Optional[int]
    source: str

    def as_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def tree_bytes(tree) -> int:
    """Total bytes of every tensor leaf (NamedTuples, dicts, tuples and
    lists are walked; other leaves count 0)."""

    return sum(x.numel() * x.element_size() for x in tu.flatten_with_keys(tree)[1]
               if isinstance(x, torch.Tensor))


def memory_report(*, example_args=None, example_out=None,
                  peak_bytes: Optional[int] = None) -> Dict[str, Any]:
    """The JSON-able memory section of a PerfRecord. ``peak_bytes`` is the
    card's measured peak; without it the section holds the trees' bytes."""

    per_device = MemoryStats(
        argument_bytes=tree_bytes(example_args) if example_args is not None else 0,
        output_bytes=tree_bytes(example_out) if example_out is not None else 0,
        temp_bytes=None, generated_code_bytes=None, alias_bytes=None,
        peak_bytes=None if peak_bytes is None else int(peak_bytes),
        source=SOURCE_TREE if peak_bytes is None else SOURCE_CUDA_PEAK,
    )
    return {"per_device": per_device.as_dict(), "n_devices": 1}
