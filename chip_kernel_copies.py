"""Edited copies of a kernel source, for the scripts that take one kernel
apart on a CUDA card (``chip_ffn_phases.py``, ``chip_decode_plans.py``).

* :func:`edit`: a string edit that must match its source once, so that a
  copy fails loudly when the kernel it edits has changed;
* :func:`stamped`: a copy whose blocks stamp ``%globaltimer`` where the
  caller's edits call ``stamp(i)``, with an entry point ``ptt_stamps``
  that copies the stamps out;
* :func:`build`: one ``nvcc`` a copy, all started together, each loaded
  with ctypes and bound by the package's ``_build._SIGNATURES``;
* :func:`phase_ends`: a stamped copy's phase ends, after the L2 flush.

The tree is never changed: the copies live in a directory the caller
owns.  Nothing of ``paddle_tpu_torch`` imports this module.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

#: stamps a block takes at most, and blocks a stamped grid at most
MAX_STAMPS, MAX_BLOCKS = 8, 4096

_STAMP = f"""\
__device__ unsigned long long g_stamps[{MAX_BLOCKS} * {MAX_STAMPS}];
// Thread 0 of the block reads the global timer into the block's stamp i
// once every thread of the block has reached it.
__device__ __forceinline__ void stamp(int i) {{
  __syncthreads();
  if (threadIdx.x == 0) {{
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    g_stamps[blockIdx.x * {MAX_STAMPS} + i] = t;
  }}
}}

"""

_STAMPS_ENTRY = """
extern "C" int ptt_stamps(unsigned long long* host, int n) {
  return (int)cudaMemcpyFromSymbol(host, g_stamps, sizeof(*host) * n);
}
"""


def card():
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def edit(src, old, new, what):
    """``src`` with ``old`` replaced by ``new``; raises unless ``src``
    (named ``what`` in the error) holds ``old`` exactly once."""
    if src.count(old) != 1:
        raise RuntimeError(f"{what} no longer has {old!r} once")
    return src.replace(old, new)


def stamped(src, what, anchor, edits):
    """``src`` with ``stamp(i)`` defined just before ``anchor`` (the
    kernel's first line), the (old, new) ``edits`` that place its calls
    (stamp 0 first in the kernel, then one a phase end, at most
    MAX_STAMPS), and ``ptt_stamps(host, n)``, which copies the first n
    stamps (block-major, MAX_STAMPS a block) to the host."""
    src = edit(src, anchor, _STAMP + anchor, what)
    for old, new in edits:
        src = edit(src, old, new, what)
    return src + _STAMPS_ENTRY


def build(build_module, out_dir, sources, entry_points):
    """{name: ctypes library} of each {name: source} copy, compiled by
    one ``nvcc`` a copy (all started together) with the package's flags
    and its ``csrc`` on the include path; ``entry_points`` bound by
    ``build_module._SIGNATURES``, and ``ptt_stamps`` where a copy has
    it."""
    jobs = []
    for name, src in sources.items():
        path = os.path.join(out_dir, f"{name}.cu")
        with open(path, "w") as f:
            f.write(src)
        so = os.path.join(out_dir, f"lib{name}.so")
        jobs.append((name, so, "ptt_stamps" in src, subprocess.Popen(
            [build_module.nvcc_path(), *build_module.NVCC_FLAGS, "-shared",
             "-I", build_module.CSRC_DIR, "-o", so, path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for name, so, has_stamps, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on the {name} copy:\n{log}")
        lib = ctypes.CDLL(so)
        for entry in entry_points:
            fn = getattr(lib, entry)
            fn.restype, fn.argtypes = build_module._SIGNATURES[entry]
        if has_stamps:
            lib.ptt_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]
        libs[name] = lib
    return libs


def phase_ends(lib, grid, n, launch, calls=9):
    """The phase ends of a stamped copy ``lib`` whose ``launch()`` runs
    ``grid`` blocks taking ``n`` stamps each, in us: the latest block's
    stamp 0 (the spread of the blocks' starts), then the latest block's
    stamp i for each i >= 1, each less the earliest block's stamp 0;
    medians of ``calls`` launches, each after the 256 MB L2 flush and a
    1 ms device-side spin that hides the host's enqueue."""
    import torch

    from paddle_tpu_torch.kernels import _build

    if grid > MAX_BLOCKS or n > MAX_STAMPS:
        raise ValueError(f"{grid} blocks of {n} stamps exceed the stamps' "
                         f"{MAX_BLOCKS} x {MAX_STAMPS}")
    host = (ctypes.c_ulonglong * (grid * MAX_STAMPS))()
    flush = torch.empty(64 * 2 ** 20, device="cuda")
    ends = []
    for _ in range(calls):
        flush.zero_()
        torch.cuda._sleep(2_000_000)
        launch()
        torch.cuda.synchronize()
        _build.check(lib.ptt_stamps(ctypes.cast(host, ctypes.c_void_p),
                                    grid * MAX_STAMPS), "stamps")
        st = np.array(host[:], dtype=np.float64).reshape(
            grid, MAX_STAMPS)[:, :n]
        t0 = st[:, 0].min()
        ends.append([st[:, 0].max() - t0]
                    + [st[:, i].max() - t0 for i in range(1, n)])
    return np.median(np.array(ends), axis=0) / 1e3
