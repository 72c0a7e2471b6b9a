"""The clock reads of ``repro_torch.perf.decode_phases`` still match the
decode kernel's source: each goes in once, in order, and the copy is the
shipped source plus the reads and the clock store, on the CPU (building
and running the copy needs a card)."""

import re

import pytest

pytest.importorskip("torch")

from repro_torch.kernels import build  # noqa: E402
from repro_torch.perf import decode_phases  # noqa: E402


def test_each_phase_read_goes_in_once_in_order(tmp_path):
    shipped = (build.CSRC / "flash_decode.cu").read_text()
    assert "PHASE(" not in shipped and "clock64" not in shipped
    edited = decode_phases.phase_source(root=tmp_path).read_text()
    reads = [int(i) for i in re.findall(r"^ +(?:if \(c == 0\) )?PHASE\((\d+)\);$", edited,
                                        flags=re.M)]
    assert reads == list(range(len(decode_phases.MARKS)))
    assert len(decode_phases.PHASES) == len(decode_phases.MARKS) - 1
    # nothing else changed: without the reads and the clock store it is the source
    stripped = re.sub(r"^ +(?:if \(c == 0\) )?PHASE\(\d+\);\n", "", edited, flags=re.M)
    assert stripped.replace(decode_phases._CLOCK, "", 1) == shipped
    others = [p.name for p in (tmp_path / "src").iterdir()
              if p.name != "flash_decode.cu" and p.read_text() != (build.CSRC / p.name).read_text()]
    assert others == []


def test_a_read_in_the_chunk_loop_times_the_first_chunk(tmp_path):
    edited = decode_phases.phase_source(root=tmp_path).read_text()
    loop = edited[edited.index("for (int c = 0; c < n_chunks; ++c)"):edited.index("// The merge.")]
    assert sorted(re.findall(r"if \(c == 0\) PHASE\((\d+)\);", loop)) == ["2", "3", "4", "5"]
