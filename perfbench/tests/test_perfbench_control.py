"""The control: the plain reference computed in TF32 (the precision below
the configurations' float32 with TF32 off) put in the program's place
fails at least one of the cell's limits, while the program, on the same
seed, passes all of them, on the card at each cell's own size (the limits
are set at that size): ``python3 -m pytest perfbench/tests -m card`` on
the H100."""

from __future__ import annotations

import json

import pytest

from perfbench import control, harness

from .cells import CELLS, ROOT


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_where_the_program_passes(card, cell, tmp_path,
                                                monkeypatch):
    monkeypatch.chdir(ROOT)
    out = tmp_path / "control.jsonl"
    assert control.main(["--workload", cell, "--seeds", "977",
                         "--controls", "1", "--out", str(out)]) == 0
    line = json.loads(out.read_text().splitlines()[0])
    limits = harness.load_spec(ROOT, cell).limits
    assert all(line["program"][k] <= v for k, v in limits.items()), line
    assert any(line["control_tf32"][k] > v for k, v in limits.items()), line
