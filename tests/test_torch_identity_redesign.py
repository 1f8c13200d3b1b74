"""The redesigned T7/T8 copy (``csrc/identity_sm90.cuh``), on the CPU: what
the host can see of it.

* The work split, modelled in numpy from the source's constants: the
  redesign's grid covers every int4 of n = 128·m values exactly once (a
  thread's kVec int4s kThreads apart, the last block's tail guarded, no
  block without work, every index in 32 bits), and so does the first
  design's grid-stride loop, at small m, at the lengths around a block's
  edge and at the street's padded ``tile_offsets`` and ``sorted_surfel``.
* The kernel's body: a thread's loads all come before its first store,
  and the launch is a plain one (no programmatic launch).
* ``copy_cuda(design=...)``: unknown designs refused, a CPU tensor refused
  under both designs and by ``chip_smoke.py``'s measurement entry
  ``split_launch`` (no plain fallback).

The CPU path against the JAX tools in interpret mode is
``tests/test_torch_probes.py``'s.

The kernels themselves are held bit for bit against each other and the
input by ``chip_smoke.py`` on a card (``identity_redesign``).
"""

import os
import re
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from streetunveiler_torch.ops.rasterizer import cuda_lib  # noqa: E402
from streetunveiler_torch.tools import probe_tax  # noqa: E402

torch.set_num_threads(1)


def _source(name):
    with open(os.path.join(cuda_lib.CSRC_DIR, name)) as f:
        return f.read()


SM90 = _source("identity_sm90.cuh")
CONST = {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);",
                                           SM90)}
THREADS, VEC = CONST["kThreads"], CONST["kVec"]
# the street's padded tile_offsets (4,801 values) and sorted_surfel
STREET = {"tile_offsets": 4864, "sorted_surfel": 1_352_064}
LENGTHS = [128 * m for m in (1, 2, 3, 76, 77, 1024)] + list(STREET.values())


def redesign_writes(n4):
    """The int4 indices the redesign's threads store, and its blocks."""
    per_block = THREADS * VEC
    blocks = -(-n4 // per_block)
    b, k, t = np.meshgrid(np.arange(blocks), np.arange(VEC),
                          np.arange(THREADS), indexing="ij")
    j = (b * per_block + k * THREADS + t).reshape(-1)
    return j[j < n4], j, blocks


def first_design_writes(n4):
    """The first design's stores: min(⌈n4/256⌉, 1024) blocks of 256
    threads, each thread striding over the grid."""
    stride = min(-(-n4 // 256), 1024) * 256
    j = (np.arange(stride)[:, None]
         + stride * np.arange(-(-n4 // stride))[None, :]).reshape(-1)
    return j[j < n4]


@pytest.mark.parametrize("n", LENGTHS)
def test_redesign_covers_every_int4_once(n):
    n4 = n // 4
    stored, computed, blocks = redesign_writes(n4)
    np.testing.assert_array_equal(np.bincount(stored, minlength=n4),
                                  np.ones(n4, np.int64))
    # no block without work, and every index it computes fits in 32 bits
    assert blocks * THREADS * VEC - n4 < THREADS * VEC
    assert computed.max() < 2 ** 32
    assert n4 <= int(re.search(r"kMaxN4 = 0x([0-9A-F]+)ll - kPerBlock",
                               SM90).group(1), 16) - THREADS * VEC


@pytest.mark.parametrize("n", LENGTHS)
def test_first_design_covers_every_int4_once(n):
    n4 = n // 4
    np.testing.assert_array_equal(
        np.bincount(first_design_writes(n4), minlength=n4),
        np.ones(n4, np.int64))


def test_redesign_loads_before_it_stores():
    body = SM90[SM90.index("copy_vec("):]
    body = body[:body.index("\n}\n")]
    loads = [m.start() for m in re.finditer(r"src\[", body)]
    stores = [m.start() for m in re.finditer(r"dst\[", body)]
    assert loads and stores
    # all loads of a thread before its first store, and no programmatic
    # launch (it lost on the probes' path, where a torch.cat comes first)
    assert max(loads) < min(stores)
    assert "griddepcontrol" not in SM90 and "cudaLaunchKernelEx" not in SM90


def test_copy_cuda_refuses():
    x = torch.arange(256, dtype=torch.int32)
    for design in probe_tax.DESIGNS:
        with pytest.raises(ValueError, match="CUDA"):
            probe_tax.copy_cuda(x, design=design)
    with pytest.raises(ValueError, match="design"):
        probe_tax.copy_cuda(x, design="sm90")
    with pytest.raises(ValueError, match="CUDA"):
        chip_smoke.split_launch(torch, "empty", x, 1, 32)
    assert set(chip_smoke.SPLIT_KINDS) == {"empty", "first_body"}
