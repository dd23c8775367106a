"""Hand-written CUDA kernels of the port and their plain PyTorch twins.

Each wrapper runs its plain version only for tensors on the CPU.  For a
CUDA tensor it launches its kernel (built from ``csrc/`` at first use) or
raises; there is no fallback.  Every launch adds one to the wrapper's
entry in :data:`launches`.

The attention and decode kernels are compiled for head width 64.  Below
that the reference's own plans decline their Pallas kernels by shape and
run the XLA composition, so on the card the port's wrappers take their
plain composition there: :func:`composes` chooses the route from the head
width before any launch (never after a failed build or launch) and
counts every composed call in :data:`composed`.
"""

from __future__ import annotations

#: kernel name -> launches since the last reset_launches()
launches = {"qkv_attention_fwd": 0, "qkv_bwd_dq": 0, "qkv_bwd_dkv": 0,
            "megastep": 0, "megastep_paged": 0, "ffn": 0, "flash_decode": 0,
            "flash_decode_paged": 0, "flash_fwd": 0, "flash_bwd_dq": 0,
            "flash_bwd_dkv": 0, "flash_fwd_bhtd": 0, "flash_bwd_dq_bhtd": 0,
            "flash_bwd_dkv_bhtd": 0, "dropout_add_fwd": 0,
            "dropout_add_bwd": 0,
            "channel_stats": 0, "dot_col_stats": 0, "ssa_fwd": 0,
            "ssa_bwd": 0, "multi_table_gather": 0, "multi_table_apply": 0}

#: kernel name -> calls on the card that took the plain composition by
#: shape (head width % 64 != 0), since the last reset_launches()
composed = {name: 0 for name in ("qkv_attention_fwd", "qkv_bwd_dq",
                                 "qkv_bwd_dkv", "megastep",
                                 "megastep_paged", "ffn", "flash_decode",
                                 "flash_decode_paged", "flash_fwd",
                                 "flash_bwd_dq", "flash_bwd_dkv",
                                 "flash_fwd_bhtd", "flash_bwd_dq_bhtd",
                                 "flash_bwd_dkv_bhtd")}

#: head width the attention and decode kernels are compiled for
KERNEL_D_HEAD = 64


def head_route(d_head: int) -> str:
    """The reference's plan for a head width: "kernel" at 64, "composed" at
    d_head % 64 != 0 (its plans decline the kernel there and run the XLA
    composition).  Other multiples of 64 raise: the reference launches its
    kernels there, and the port's are compiled for 64 only."""
    if d_head == KERNEL_D_HEAD:
        return "kernel"
    if d_head % 64:
        return "composed"
    raise ValueError(
        f"head width {d_head}: the CUDA kernels are compiled for head width "
        f"{KERNEL_D_HEAD}; other multiples of 64 are not ported")


def composes(what: str, d_head: int) -> bool:
    """For a wrapper called on CUDA tensors: True (and one more in
    ``composed[what]``) when the head width sends the call to the plain
    composition, False when the kernel launches; raises where neither
    applies (:func:`head_route`)."""
    if head_route(d_head) == "kernel":
        return False
    composed[what] += 1
    return True


def reset_launches() -> None:
    for counts in (launches, composed):
        for name in counts:
            counts[name] = 0
