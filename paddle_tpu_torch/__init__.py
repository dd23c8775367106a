"""paddle_tpu_torch: the PyTorch/CUDA port of paddle_tpu.

It trains and serves the encoder-decoder Transformer.  Training takes the
reference's f32 step with Paddle's Adam, on the fused-qkv attention route
by default (``fused_qkv_attention=False`` takes the flag-off route):

    model = Transformer(**widths).init_params(0)
    opt = Adam(model.parameters(), learning_rate=1e-4)
    avg_cost, _ = model(**{k: torch.from_numpy(v).cuda()
                           for k, v in make_batch(...).items()})
    opt.minimize(avg_cost)          # backward, update, gradients reset

Serving is greedy generation on ring or paged KV caches, one session or a
continuous batcher:

    model = Transformer(**widths).init_params(seed)   # on CUDA by default
    sess = GenerationSession(model, batch_size, src_seq_len, max_out_len)
    tokens, steps = sess.generate(src_word)

    served = GenerationServingModel(GenerationConfig("m", slots=64, ...))
    batcher = ContinuousBatcher(served)
    batcher.start(); tokens, meta = batcher.submit(prompt)

Eleven hand-written CUDA kernels carry it (``kernels/``); every other
operation is plain PyTorch.  Pass ``device="cpu"`` to run every kernel's
plain twin instead.  The package imports neither JAX nor ``paddle_tpu``.
"""

from .device import resolve_device  # noqa: F401
from .generation import (BlockAllocator, GenerationSession,  # noqa: F401
                         KVCache, PagedKVCache)
from .interop import (export_paddle_tpu_adam_state,  # noqa: F401
                      export_paddle_tpu_params, load_paddle_tpu_adam_state,
                      load_paddle_tpu_params)
from .models.transformer import (Transformer, make_batch,  # noqa: F401
                                 training_biases)
from .optimizer import Adam  # noqa: F401
from .serving import (ContinuousBatcher, GenerationConfig,  # noqa: F401
                      GenerationServingModel)
