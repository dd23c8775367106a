"""Hand-written CUDA kernels of the port and their plain PyTorch twins.

Each wrapper runs its plain version only for tensors on the CPU.  For a
CUDA tensor it launches its kernel (built from ``csrc/`` at first use) or
raises; there is no fallback.  Every launch adds one to the wrapper's
entry in :data:`launches`; a kernel with a bf16 instantiation (amp,
:data:`BF16_KERNELS`) counts its bf16 launches under its name + "_bf16",
and one compiled for head width 128 (:data:`HEAD_WIDTHS`) its launches at
that width under that name + "_dh128" (:func:`width_suffix`): #4 at 128
in f32 would count under ``flash_fwd_dh128``, in bf16 under
``flash_fwd_bf16_dh128``.

The attention and decode kernels are compiled for head width 64; for 128
too the serving path's f32 ones (#1's forward, the megasteps and
flash-decode) and the bf16 training kernels (#1 to #9, amp's attention):
:data:`HEAD_WIDTHS` says which widths each kernel and dtype takes.  The
f32 training kernels (the pair #2 + #3 and #4 to #9) take 64 only.  The
FFN (#11, #13) has no head axis and runs at every width.
Below a multiple of 64 the reference's own plans decline their Pallas
kernels by shape and run the XLA composition, so on the card the port's
wrappers take their plain composition there.  At a
multiple of 64 the reference launches; the port's wrappers launch where
their kernel is compiled for the width and raise elsewhere.
:func:`composes` chooses the route from the kernel, the dtype and the
head width before any launch (never after a failed build or launch),
counts every composed call in :data:`composed` and raises, naming the
kernel and the width, where no kernel is compiled.
"""

from __future__ import annotations

import torch

#: kernel name -> launches since the last reset_launches()
launches = {"qkv_attention_fwd": 0, "qkv_bwd_dq": 0, "qkv_bwd_dkv": 0,
            "megastep": 0, "megastep_paged": 0, "ffn": 0, "flash_decode": 0,
            "flash_decode_paged": 0, "flash_fwd": 0, "flash_bwd_dq": 0,
            "flash_bwd_dkv": 0, "flash_fwd_bhtd": 0, "flash_bwd_dq_bhtd": 0,
            "flash_bwd_dkv_bhtd": 0, "dropout_add_fwd": 0,
            "dropout_add_bwd": 0,
            "channel_stats": 0, "dot_col_stats": 0, "ssa_fwd": 0,
            "ssa_bwd": 0, "multi_table_gather": 0, "multi_table_apply": 0,
            "gemm": 0}
#: the bf16 instantiations (amp), counted apart from the f32 kernels
BF16_KERNELS = ("qkv_attention_fwd", "qkv_bwd_dq", "qkv_bwd_dkv",
                "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
                "flash_fwd_bhtd", "flash_bwd_dq_bhtd", "flash_bwd_dkv_bhtd",
                "dropout_add_fwd", "dropout_add_bwd", "channel_stats",
                "dot_col_stats", "ssa_fwd", "ssa_bwd")
launches.update({name + "_bf16": 0 for name in BF16_KERNELS})
#: element types those kernels are compiled for -> the suffix of their
#: entry points and launch counters
KERNEL_DTYPES = {torch.float32: "", torch.bfloat16: "_bf16"}

#: kernel name -> calls on the card that took the plain composition by
#: shape (head width % 64 != 0), since the last reset_launches()
composed = {name: 0 for name in ("qkv_attention_fwd", "qkv_bwd_dq",
                                 "qkv_bwd_dkv", "megastep",
                                 "megastep_paged", "ffn", "flash_decode",
                                 "flash_decode_paged", "flash_fwd",
                                 "flash_bwd_dq", "flash_bwd_dkv",
                                 "flash_fwd_bhtd", "flash_bwd_dq_bhtd",
                                 "flash_bwd_dkv_bhtd")}

#: (kernel, dtype) -> the head widths its instantiation is compiled for,
#: where more than 64: the serving path's f32 attention and decode
#: kernels, and the bf16 attention kernels amp trains with.  Every other
#: one (the f32 training kernels among them) takes 64 only.
HEAD_WIDTHS = {
    **{(name, torch.float32): (64, 128)
       for name in ("qkv_attention_fwd", "megastep", "megastep_paged",
                    "flash_decode", "flash_decode_paged")},
    **{(name, torch.bfloat16): (64, 128)
       for name in ("qkv_attention_fwd", "qkv_bwd_dq", "qkv_bwd_dkv",
                    "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
                    "flash_fwd_bhtd", "flash_bwd_dq_bhtd",
                    "flash_bwd_dkv_bhtd")}}
#: the counters of the head-width-128 instantiations, less "_dh128": the
#: kernel's name and its dtype's suffix (``flash_fwd_bf16``)
DH128_KERNELS = tuple(name + KERNEL_DTYPES[dtype]
                      for name, dtype in HEAD_WIDTHS)
launches.update({name + "_dh128": 0 for name in DH128_KERNELS})


def compiled_widths(name: str, dtype=torch.float32) -> tuple:
    """The head widths kernel ``name``'s ``dtype`` instantiation is
    compiled for."""
    return HEAD_WIDTHS.get((name, dtype), (64,))


def width_suffix(d_head: int) -> str:
    """The suffix of a launch counter at this head width: "" at 64,
    "_dh128" at 128."""
    return "" if d_head == 64 else f"_dh{d_head}"


def head_route(name: str, d_head: int, dtype=torch.float32) -> str:
    """The route of kernel ``name`` on ``dtype`` tensors at this head
    width, as the reference's plans decide it: "composed" at d_head % 64
    != 0 (its plans decline the kernel and run the XLA composition),
    "kernel" where the port's instantiation is compiled for the width.
    Another multiple of 64 raises a ValueError naming the kernel and the
    width: the reference launches there, and the port has no kernel."""
    if d_head % 64:
        return "composed"
    widths = compiled_widths(name, dtype)
    if d_head in widths:
        return "kernel"
    kind = "" if dtype == torch.float32 else f" {dtype}"
    raise ValueError(
        f"{name}{kind}: no CUDA kernel for head width {d_head} (compiled "
        f"for {', '.join(str(w) for w in widths)})")


def composes(name: str, d_head: int, dtype=torch.float32) -> bool:
    """For a wrapper called on CUDA tensors: True (and one more in
    ``composed[name]``) when the head width sends the call to the plain
    composition, False when the kernel launches; raises where neither
    applies (:func:`head_route`)."""
    if head_route(name, d_head, dtype) == "kernel":
        return False
    composed[name] += 1
    return True


def reset_launches() -> None:
    for counts in (launches, composed):
        for name in counts:
            counts[name] = 0
