"""Hand-written CUDA kernels of the port and their plain PyTorch twins.

Each wrapper runs its plain version only for tensors on the CPU.  For a
CUDA tensor it launches its kernel (built from ``csrc/`` at first use) or
raises; there is no fallback.  Every launch adds one to the wrapper's
entry in :data:`launches`.
"""

from __future__ import annotations

#: kernel name -> launches since the last reset_launches()
launches = {"qkv_attention_fwd": 0, "qkv_bwd_dq": 0, "qkv_bwd_dkv": 0,
            "megastep": 0, "megastep_paged": 0, "ffn": 0, "flash_decode": 0,
            "flash_decode_paged": 0, "flash_fwd": 0, "flash_bwd_dq": 0,
            "flash_bwd_dkv": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0
