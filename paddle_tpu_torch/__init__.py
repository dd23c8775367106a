"""paddle_tpu_torch: the PyTorch/CUDA port of paddle_tpu.

It trains and serves the encoder-decoder Transformer.  Training takes the
reference's f32 step with Paddle's Adam and its dropout (``dropout_rate``;
one uint32 seed per site and step, from ``dropout_seeds=`` or drawn from
``generator=``), on the fused-qkv attention route by default
(``fused_qkv_attention=False`` takes the flag-off route):

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

It also trains ResNet (18 to 152; ResNet-50 is the reference's headline
workload) with Paddle's Momentum, on the reference's NHWC fused conv +
batch-norm route, in f32:

    model = ResNet(depth=50, class_dim=1000).init_params(0)
    opt = Momentum(model.parameters(), learning_rate=0.1, momentum=0.9)
    avg_cost, acc, predict = model(image, label)   # NCHW f32, int64 [N, 1]
    opt.minimize(avg_cost)

``data_format="NCHW"`` or ``fused_bn=False`` trains through the
reference's unfused composition (``F.conv2d``, ``batch_norm_composed``)
instead, with no kernel.

It trains DeepFM, the reference's sparse CTR workload, with lazy Adam (or
SGD) on row-sparse table gradients; with ``fused_embedding`` (the
default) the 52 lookups are two #22 launches and the table updates two #23
launches a step:

    model = DeepFM(hash_dim=1000001).init_params(0)
    opt = Adam(model.parameters(), learning_rate=1e-3, lazy_mode=True)
    feed = make_deepfm_batch(4096, hash_dim=1000001)
    avg_cost, auc, predict = model(*batch_tensors(feed))   # models.deepfm
    opt.minimize(avg_cost)

It pretrains BERT (masked LM, Paddle's Adam, f32) on the reference's
routes: its default build spells attention out by hand, and
``attention_fuse`` switches those sites to
``layers.contrib.fused_attention`` in the bhtd layout (#5, #8, #9);
``use_flash=True`` takes the fused-qkv kernels (#1-#3):

    model = BertPretrain(30522, 128, 12, 12, 768, 3072, 0.1).init_params(0)
    attention_fuse(model)           # returns the 12 sites it switched
    opt = Adam(model.parameters(), learning_rate=1e-4)
    avg_loss, enc = model(**{k: torch.from_numpy(v).cuda()
                             for k, v in make_bert_batch(128, 128,
                                                         30522).items()})
    opt.minimize(avg_loss)

Twenty-two hand-written CUDA kernels carry all of it (``kernels/``); every
other operation is plain PyTorch, the convolutions that are not 1x1
included (cuDNN on the card; turn its TF32 off for the f32 step).  At a
head width % 64 != 0 the attention and decode kernels give way to their
plain composition by shape, as the reference's plans do, and count it in
``kernels.composed``.  Pass ``device="cpu"`` to run every kernel's plain
twin instead.  The package imports neither JAX nor ``paddle_tpu``.
"""

from .device import resolve_device  # noqa: F401
from .generation import (BlockAllocator, GenerationSession,  # noqa: F401
                         KVCache, PagedKVCache)
from .interop import (export_paddle_tpu_adam_state,  # noqa: F401
                      export_paddle_tpu_bert_params,
                      export_paddle_tpu_deepfm_params,
                      export_paddle_tpu_params,
                      export_paddle_tpu_resnet_params,
                      load_paddle_tpu_adam_state,
                      load_paddle_tpu_bert_params,
                      load_paddle_tpu_deepfm_params,
                      load_paddle_tpu_momentum_state, load_paddle_tpu_params,
                      load_paddle_tpu_resnet_params)
from .layers import contrib  # noqa: F401
from .models.bert import BertPretrain  # noqa: F401
from .models.bert import make_batch as make_bert_batch  # noqa: F401
from .models.deepfm import DeepFM  # noqa: F401
from .models.deepfm import make_batch as make_deepfm_batch  # noqa: F401
from .models.resnet import ResNet  # noqa: F401
from .models.transformer import (Transformer, make_batch,  # noqa: F401
                                 training_biases)
from .optimizer import SGD, Adam, Momentum  # noqa: F401
from .passes import attention_fuse  # noqa: F401
from .serving import (ContinuousBatcher, GenerationConfig,  # noqa: F401
                      GenerationServingModel)
