"""paddle_tpu_torch: the PyTorch/CUDA port of paddle_tpu.

This slice serves greedy generation on the encoder-decoder Transformer:

    model = Transformer(**widths).init_params(seed)   # on CUDA by default
    sess = GenerationSession(model, batch_size, src_seq_len, max_out_len)
    tokens, steps = sess.generate(src_word)

Three hand-written CUDA kernels carry it (``kernels/``); every other
operation is plain PyTorch.  The package imports neither JAX nor
``paddle_tpu``.
"""

from .device import resolve_device  # noqa: F401
from .generation import GenerationSession, KVCache  # noqa: F401
from .interop import load_paddle_tpu_params  # noqa: F401
from .models.transformer import Transformer  # noqa: F401
