"""The edits of ``repro_torch.perf.attn_ablation`` still match the kernel
sources: each variant changes its source in exactly the one place it
names, on the CPU (building and timing the variants needs a card)."""

import pytest

pytest.importorskip("torch")

from repro_torch.kernels import build  # noqa: E402
from repro_torch.perf import attn_ablation  # noqa: E402

VARIANTS = [(kernel, v) for kernel, (_, _, variants) in attn_ablation.KERNELS.items()
            for v in variants]


@pytest.mark.parametrize("kernel,variant", VARIANTS)
def test_each_ablation_edits_its_source_once(tmp_path, kernel, variant):
    src = attn_ablation.variant_source(kernel, variant, root=tmp_path)
    name, _, old, new = attn_ablation.KERNELS[kernel][2][variant]
    before = (build.CSRC / name).read_text()
    after = (src.parent / name).read_text()
    assert after != before and len(after) == len(before) - len(old) + len(new)
    changed = [p.name for p in src.parent.iterdir() if p.read_text() != (build.CSRC / p.name)
               .read_text()]
    assert changed == [name]


def test_base_is_the_sources_unchanged(tmp_path):
    for kernel in attn_ablation.KERNELS:
        src = attn_ablation.variant_source(kernel, None, root=tmp_path)
        assert src.exists() and all(p.read_text() == (build.CSRC / p.name).read_text()
                                    for p in src.parent.iterdir())
