"""The port's one-card dry run on the CPU: the meta dispatch rule, the
roofline's counters (FLOPs against XLA's ``cost_analysis`` of the JAX
package's prefill, the kernel-region rule), the prefill and decode steps
of ``launch.specs.make_step`` against the JAX package's ``prefill`` /
``decode_step``, and ``launch.dryrun.run_one(device="meta")`` for
zamba2-7b at all four input shapes.

Tolerances: logits within ``LLM_RTOL`` of their scale; caches within
``LLM_RTOL`` of each leaf's scale (attention K/V are projections of the
same inputs; the SSM state and conv window follow the scan as the logits
do).  FLOPs: ``FlopCounterMode`` counts matmuls, einsums and attention,
and XLA also counts every elementwise op, so the port's count lies in
``FLOP_BAND`` of XLA's (0.949-0.994 over the ten ``-smoke`` configs,
printed by running this file as a script: the SSM configs lowest, their
scans being the most elementwise)."""
import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import transformer as JT
from repro_torch import weights
from repro_torch.configs import INPUT_SHAPES, get_config, list_archs
from repro_torch.configs.base import ShapeConfig
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import ssd_scan as sk
from repro_torch.launch import dryrun, profile, specs
from repro_torch.models import schema as sch
from repro_torch.models import transformer as TT
from repro_torch.roofline.analysis import analyze_step
from repro_torch.roofline.hw import H100
from repro_torch.testing import LLM_RTOL, rel_err
from test_torch_bf16 import assert_layers_match_jax

torch.set_num_threads(1)

FLOP_BAND = (0.93, 1.0)


def meta(*shape, grad=False, dtype=torch.float32):
    return torch.empty(shape, device="meta",
                       dtype=dtype).requires_grad_(grad)


@pytest.fixture(params=["float32", "bfloat16"])
def compute_dtype(request, monkeypatch):
    """The steps' compute dtype, set in ``launch.specs`` for the test:
    bfloat16 is the reference's and the default, float32 the port's
    earlier one (its expectations unchanged)."""
    dtype = getattr(torch, request.param)
    monkeypatch.setattr(specs, "COMPUTE_DTYPE", dtype)
    return dtype


# ---------------------------------------------------------------------------
# the meta dispatch rule
# ---------------------------------------------------------------------------
def test_meta_tensors_take_the_plain_version_and_launch_nothing():
    ops.reset_launch_counts()
    out = ops.flash_attention(meta(2, 64, 8, 32), meta(2, 64, 2, 32),
                              meta(2, 64, 2, 16))
    assert out.is_meta and out.shape == (2, 64, 8, 16)
    y, fin = ops.ssd_scan(meta(1, 100, 4, 8), meta(1, 100, 4), meta(4),
                          meta(1, 100, 16), meta(1, 100, 16), chunk=32)
    assert y.shape == (1, 100, 4, 8) and fin.shape == (1, 4, 8, 16)
    att = ops.decode_attention(meta(2, 8, 32), meta(2, 128, 2, 32),
                               meta(2, 128, 2, 32), 100)
    assert att.is_meta and att.shape == (2, 8, 32)
    assert ops.iou_matrix(meta(3, 5, 4), meta(3, 7, 4)).shape == (3, 5, 7)
    assert all(n == 0 for n in ops.launch_counts().values())


def test_other_devices_still_raise():
    odd = SimpleNamespace(is_cuda=False, device=torch.device("xpu"))
    with pytest.raises(ValueError, match="no kernel for device xpu"):
        ops._on_card(odd)
    assert ops._on_card(torch.zeros(1)) is False
    assert ops._on_card(meta(1, grad=True)) is False


def test_meta_operands_that_require_grad_take_the_plain_path():
    # no autograd.Function on meta: the plain version is differentiated,
    # so a train step can be counted; nothing launches, no VJP is counted
    ops.reset_launch_counts()
    q, k, v = meta(1, 32, 4, 16, grad=True), meta(1, 32, 4, 16), \
        meta(1, 32, 4, 16)
    out = ops.flash_attention(q, k, v)
    assert out.requires_grad and out.is_meta
    assert not isinstance(out.grad_fn, fa.FlashAttention._backward_cls)
    (g,) = torch.autograd.grad(out.sum(), q)
    assert g.is_meta and g.shape == q.shape
    x = meta(1, 64, 2, 8, grad=True)
    y, fin = ops.ssd_scan(x, meta(1, 64, 2), meta(2), meta(1, 64, 8),
                          meta(1, 64, 8), chunk=16)
    assert not isinstance(y.grad_fn, sk.SSDScan._backward_cls)
    (gx,) = torch.autograd.grad(y.sum() + fin.sum(), x)
    assert gx.shape == x.shape
    assert all(n == 0 for n in ops.launch_counts().values())


# ---------------------------------------------------------------------------
# the counters
# ---------------------------------------------------------------------------
def test_a_kernel_is_charged_as_the_kernel_not_its_plain_version(
        compute_dtype):
    # the plain K6 materialises b x heads x s x s scores; the region
    # charges q, k, v and the output, and counts the plain FLOPs; bf16
    # operands are 2 bytes each and their products run at the bf16 rate
    b, s, h, d = 1, 4096, 8, 64
    shape = ShapeConfig("t", s, b, "prefill")
    cfg = get_config("qwen2-7b-smoke")
    size = compute_dtype.itemsize

    def step(q, k, v):
        return ops.flash_attention(q, k, v)

    args = tuple(meta(b, s, h, d, dtype=compute_dtype) for _ in range(3))
    rep = analyze_step(step, args, arch="t", shape=shape, cfg=cfg)
    operand = size * b * s * h * d
    scores = size * b * h * s * s
    assert rep.kernel_calls == {"flash_attention": 1}
    assert rep.hlo_bytes == 4 * operand
    assert rep.peak_memory_per_device == 4 * operand < scores
    assert rep.arg_bytes == 3 * operand and rep.output_bytes == operand
    assert rep.hlo_flops == 2 * 2 * b * h * s * s * d      # q.k and p.v
    # the floor takes the plain s x s out and charges the causal pairs,
    # their products in 3xTF32 on float32, at the bf16 rate on bf16
    pairs = b * h * s * (s + 1) // 2
    assert rep.kernel_plain_flops == rep.hlo_flops
    assert rep.kernel_products == pairs * 4 * d
    assert rep.kernel_other == pairs * 5
    if compute_dtype == torch.float32:
        assert rep.compute_dtype == "fp32" and rep.kernel_products_bf16 == 0
        assert rep.t_compute == pytest.approx(
            pairs * 5 / H100.peak_flops_fp32
            + 3 * pairs * 4 * d / H100.peak_flops_tf32, rel=1e-12)
    else:
        assert rep.compute_dtype == "bf16"
        assert rep.kernel_products_bf16 == rep.kernel_products
        assert rep.t_compute == pytest.approx(
            (pairs * 5 + pairs * 4 * d) / H100.peak_flops_bf16, rel=1e-12)
    # K7's and K8's workspaces (float32 either way) are written, read and
    # live
    q, kc = meta(2, 8, 32, dtype=compute_dtype), meta(2, 256, 2, 32,
                                                      dtype=compute_dtype)
    rep = analyze_step(lambda q, k, v: ops.decode_attention(q, k, v, 200),
                       (q, kc, meta(2, 256, 2, 32, dtype=compute_dtype)),
                       arch="t", shape=shape, cfg=cfg)
    # at the splits the card runs: bf16's TMA kernel fills an H100's 132
    # resident blocks as far as 16 tiles of 16 slots go (2 blocks a split)
    ws = da.workspace_bytes(q, kc, kc, None, da.H100_RESIDENT)
    _, nsplit = da.plan(q, kc, kc, None, da.H100_RESIDENT)
    assert nsplit == (16 if compute_dtype == torch.bfloat16
                      else da.splits(2, 256, 2, None)[1])
    assert ws == 4 * 2 * 8 * nsplit * (32 + 2)
    assert rep.hlo_bytes == size * (2 * 8 * 32 * 2 + 2 * 2 * 256 * 2 * 32) \
        + 2 * ws


def test_a_meta_backward_holds_what_the_cards_recomputed_vjp_holds():
    # on the card K6's and K8's backward recompute their plain version
    # under autograd before its VJP (flash_attention_vjp, ssd_scan_vjp),
    # and the kernel forward holds none of its intermediates.  On meta the
    # same Function runs with the kernel region as its forward: the
    # forward's peak stays below one float32 score tensor, the backward's
    # holds the recomputed probabilities beside their cotangent, the
    # logits' and the CUDA softmax backward's grad * output (the plain
    # version differentiated in place of the kernel held 2.125 score
    # tensors at most: its saved probabilities went uncounted)
    b, s, h, d = 1, 512, 4, 16
    shape = ShapeConfig("t", s, b, "train")
    cfg = get_config("qwen2-7b-smoke")
    scores = 4 * b * h * s * s

    def forward(q, k, v):
        return ops.flash_attention(q, k, v)

    def backward(q, k, v):
        return torch.autograd.grad(ops.flash_attention(q, k, v).sum(),
                                   (q, k, v))

    def args():
        return tuple(meta(b, s, h, d, grad=True) for _ in range(3))
    out = forward(*args())
    assert isinstance(out.grad_fn, ops._MetaFlashAttention._backward_cls)
    fwd = analyze_step(forward, args(), arch="t", shape=shape, cfg=cfg)
    assert fwd.peak_memory_per_device < scores
    bwd = analyze_step(backward, args(), arch="t", shape=shape, cfg=cfg)
    assert bwd.peak_memory_per_device >= 4 * scores
    assert bwd.kernel_calls == {"flash_attention": 1}
    x = meta(1, 64, 2, 8, grad=True)
    y, _ = ops.ssd_scan(x, meta(1, 64, 2), meta(2), meta(1, 64, 8),
                        meta(1, 64, 8), chunk=16)
    assert isinstance(y.grad_fn, ops._MetaSSDScan._backward_cls)
    assert all(n == 0 for n in ops.launch_counts().values())


def test_a_train_card_pass_warms_up_on_its_own_adamw_state(monkeypatch):
    # a second AdamW state (float32, twice the parameters) beside the
    # step's would pass the card at musicgen's train_4k: the warm-up step
    # takes the timed step's; its launches and plain VJPs are counted
    from repro_torch.training.optimizer import AdamW
    cfg = get_config("musicgen-medium-smoke")
    shape = ShapeConfig("train_4k", 16, 2, "train")
    params = TT.init_params(cfg, 0, "cpu", specs.COMPUTE_DTYPE)
    state = AdamW().init(params)
    real = dryrun.step_inputs(cfg, shape, "cpu", params, state)
    assert real[0] is params and real[1] is state
    assert set(real[2]) == {"tokens", "labels", "ctx_embed"}
    inits = []
    monkeypatch.setattr(AdamW, "init", lambda self, p, _init=AdamW.init: (
        inits.append(1), _init(self, p))[1])
    monkeypatch.setattr(dryrun, "require_device",
                        lambda _: torch.device("cpu"))
    for name in ("synchronize", "empty_cache", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, name, lambda *a: None)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda *a: 0)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: "cpu")

    class Event:
        def __init__(self, **kw):
            pass

        def record(self):
            pass

        def synchronize(self):
            pass

        def elapsed_time(self, other):
            return 1.0
    monkeypatch.setattr(torch.cuda, "Event", Event)
    dry = {"max_batch": 2, "cut_t_floor": 1e-3, "cut_peak_bytes": 1,
           "cut_dominant": "memory"}
    got = dryrun.card_pass(cfg, shape, dry)
    assert len(inits) == 1                  # the timed step's state only
    assert got["finite"] and got["calls"] == 1 and got["batch"] == 2
    assert set(got["launches"]) == set(dryrun.STEP_KERNELS
                                       + dryrun.STEP_VJPS)


def test_the_byte_counter_follows_the_eager_program():
    # an op moves its operands and result; a view nothing; a scatter into
    # a cache its values twice; a freed tensor leaves the live set
    cfg = get_config("qwen2-7b-smoke")
    shape = ShapeConfig("t", 8, 1, "prefill")

    def step(x, cache):
        y = x * 2.0                      # 4 KiB read, 4 KiB written
        z = y.t()                        # a view: nothing
        cache.index_copy_(0, torch.tensor([3], device="meta"), z[:1])
        w = (y + 1.0).sum()              # y+1 made and freed
        return w

    x, cache = meta(32, 32), meta(1024, 32)
    rep = analyze_step(step, (x, cache), arch="t", shape=shape, cfg=cfg)
    kib = 4096
    # mul reads x, writes y; the scatter reads its 8-byte index and 128 B
    # of values and writes as many; add reads y, writes a temporary; sum
    # reads it, writes 4 B
    assert rep.hlo_bytes == 2 * kib + 2 * (8 + 128) + 2 * kib + kib + 4
    assert rep.arg_bytes == kib + 32 * kib
    # at the end: the arguments, y, the temporary and the sum
    assert rep.peak_memory_per_device == rep.arg_bytes + 2 * kib + 4
    assert rep.kernel_calls == {}


def test_the_peak_holds_a_large_bf16_sums_float32_buffer():
    # past 2^31 - 1 elements a CUDA sum into bf16 accumulates in a float32
    # buffer of the output's size (deepseek-v2-lite's MoE combine at
    # prefill_32k: 1.61 GB on an H100); a float32 output or a smaller
    # input holds none
    cfg = get_config("qwen2-7b-smoke")
    shape = ShapeConfig("t", 8, 1, "prefill")

    def step(x):
        return x.sum(dim=1)

    for n, dtype, extra in ((2 ** 31, torch.bfloat16, 4 * 2 ** 30),
                            (2 ** 30, torch.bfloat16, 0),
                            (2 ** 31, torch.float32, 0)):
        x = torch.empty((2 ** 30, n // 2 ** 30), dtype=dtype, device="meta")
        rep = analyze_step(step, (x,), arch="t", shape=shape, cfg=cfg)
        out = 2 ** 30 * x.element_size()
        assert rep.peak_memory_per_device == rep.arg_bytes + out + extra


def test_the_peak_holds_the_softmax_backwards_product():
    # PyTorch's CUDA softmax backward forms grad * output, the gradient's
    # size, beside its result (8.05 GB of float32 scores in musicgen's
    # train_4k VJP at 5 rows on an H100); the forward holds none
    cfg = get_config("qwen2-7b-smoke")
    shape = ShapeConfig("t", 8, 1, "train")
    x = meta(64, 256, grad=True)
    n = 4 * 64 * 256

    def forward(x):
        return torch.softmax(x, -1)

    def backward(x):
        return torch.autograd.grad(torch.softmax(x, -1), x,
                                   torch.ones_like(x))
    rep = analyze_step(forward, (x,), arch="t", shape=shape, cfg=cfg)
    assert rep.peak_memory_per_device == 2 * n
    rep = analyze_step(backward, (x,), arch="t", shape=shape, cfg=cfg)
    # x, the saved output, the cotangent, the result and the product
    assert rep.peak_memory_per_device == 5 * n


@pytest.mark.parametrize("kind", ["affine", "train"])
def test_fit_batch_finds_the_largest_batch_that_fits(monkeypatch, kind):
    # a prefill's or a decode step's peak is affine in the batch: the
    # extrapolation from batch 1 and the full batch is the largest, and
    # one pass confirms it.  A train step's is the AdamW update's (the
    # same at any batch) until the backward's passes it: from batch 1 the
    # extrapolation falls short, and the batches above are tried while they
    # fit (musicgen-medium's train_4k: 4 from batch 1, 7 in truth)
    gb = 1e9
    peak = {"affine": lambda b: 20 * gb + 3 * gb * b,
            "train": lambda b: max(56.3 * gb, 27.4 * gb + 7.2 * gb * b)}[
                kind]
    passes = []

    def fake_pass(cfg, shape, arch):
        passes.append(shape.global_batch)
        return SimpleNamespace(peak_memory_per_device=peak(
            shape.global_batch))
    monkeypatch.setattr(dryrun, "abstract_pass", fake_pass)
    shape = ShapeConfig("t", 8, 256, "train")
    full = fake_pass(None, shape, "t")
    b, rep, one = dryrun.fit_batch(None, shape, "t", full)
    largest = max(n for n in range(1, 256) if peak(n) <= H100.hbm_bytes)
    assert b == largest == {"affine": 20, "train": 7}[kind]
    assert rep.peak_memory_per_device == peak(b)
    assert one.peak_memory_per_device == peak(1)
    # affine: the full batch, batch 1, the pick; train: then up while a
    # row's extrapolated slope still fits beside the last pass's peak
    assert passes == {"affine": [256, 1, 20],
                      "train": [256, 1, 4, 5, 6, 7]}[kind]


@pytest.mark.parametrize("s_q,s_kv,causal,window,q_offset", [
    (64, 64, True, None, 0), (16, 80, True, None, 64),
    (16, 80, True, 24, 64), (48, 48, True, 8, 0), (32, 40, False, None, 0),
    (32, 40, False, 6, 3), (7, 100, True, 5, 200)])
def test_causal_pairs_count_what_the_mask_lets_through(s_q, s_kv, causal,
                                                       window, q_offset):
    qp = np.arange(s_q)[:, None] + q_offset
    kp = np.arange(s_kv)[None, :]
    mask = np.ones((s_q, s_kv), bool)
    if causal:
        mask &= qp >= kp
    if window is not None:
        mask &= qp - kp < window
    assert fa.causal_pairs(s_q, s_kv, causal=causal, window=window,
                           q_offset=q_offset) == int(mask.sum())


def test_kernel_work_counts_each_kernels_own_operations():
    # K6 with a tensor offset (no value on meta): the queries are the
    # keys' last rows; K7 over the valid slots, the window's, or the whole
    # cache for a tensor length; K8 the chunked form's products
    q, k, v = meta(2, 16, 8, 32), meta(2, 80, 2, 32), meta(2, 80, 2, 16)
    pairs = fa.causal_pairs(16, 80, causal=True, window=None, q_offset=64)
    assert fa.work(q, k, v, q_offset=meta(2).long()) == fa.work(
        q, k, v, q_offset=64) == (2 * 8 * pairs * 2 * (32 + 16),
                                  2 * 8 * pairs * 5, 0, 0)
    assert fa.work(q, k, v, softcap=30.0, q_offset=64)[1] == \
        2 * 8 * pairs * 8
    qd, kc = meta(2, 8, 32), meta(2, 256, 2, 32)
    assert da.work(qd, kc, kc, 200) == fa.pair_work(2 * 8 * 200, 32, 32,
                                                    None)
    assert da.work(qd, kc, kc, 200, window=64) == fa.pair_work(
        2 * 8 * 64, 32, 32, None)
    assert da.work(qd, kc, kc, meta(2).long()) == fa.pair_work(
        2 * 8 * 256, 32, 32, None)
    x, B = meta(2, 100, 4, 8), meta(2, 100, 16)
    mma, other, cbt = sk.chunked_ops(2, 100, 4, 8, 16, 32)
    assert sk.work(x, meta(2, 100, 4), meta(4), B, B, chunk=32) == \
        (mma, other, 0, 0)
    # bf16 x, B and C: C B^T (2n a causal pair) is a bf16 product, each
    # other product has one bf16 operand
    x16, B16 = x.to(torch.bfloat16), B.to(torch.bfloat16)
    pairs = 32 * 33 // 2 * 3 + 4 * 5 // 2
    assert cbt == 2 * 4 * 2 * 16 * pairs
    assert sk.work(x16, meta(2, 100, 4), meta(4), B16, B16, chunk=32) == \
        (mma, other, cbt, mma - cbt)
    # the decode step's K7: the plain version's einsums count what the
    # kernel's products are, at a full cache
    rep = analyze_step(lambda q, k: ops.decode_attention(q, k, k, 256),
                       (qd, kc), arch="t", shape=ShapeConfig(
                           "t", 256, 2, "decode"),
                       cfg=get_config("qwen2-7b-smoke"))
    assert rep.kernel_plain_flops == rep.kernel_products == \
        2 * 8 * 256 * 4 * 32


def flop_ratio(name: str, b: int = 2, s: int = 64) -> float:
    """The port's FLOPs of the ``-smoke`` prefill step over XLA's
    ``cost_analysis()`` FLOPs of the JAX package's prefill
    (``impl="ref_unchunked"``, blocks unrolled: XLA counts a scan's body
    once), jitted on the CPU with no shardings."""
    jcfg, tcfg = jax_config(name).reduced(), get_config(name).reduced()
    shape = ShapeConfig("smoke", s, b, "prefill")
    fn, args, _, _ = specs.make_step(tcfg, shape)
    ours = analyze_step(fn, args, arch=name, shape=shape,
                        cfg=tcfg).hlo_flops
    jp = jax.eval_shape(lambda: JT.init_params(jcfg, jax.random.PRNGKey(0)))
    cache = jax.eval_shape(lambda: JT.init_cache(jcfg, b, s))
    toks = jax.ShapeDtypeStruct((b, s), jnp.int32)
    ctx = (jax.ShapeDtypeStruct((b, jcfg.num_ctx_tokens,
                                 jcfg.ctx_dim or jcfg.d_model), jnp.float32)
           if jcfg.num_ctx_tokens else None)
    prefill = jax.jit(lambda p, t, c, x: JT.prefill(
        jcfg, p, t, c, ctx_embed=x, impl="ref_unchunked",
        unroll_blocks=True))
    cost = prefill.lower(jp, toks, cache, ctx).compile().cost_analysis()
    cost = cost[0] if isinstance(cost, list) else cost
    return ours / float(cost["flops"])


@pytest.mark.parametrize("name", list_archs())
def test_prefill_flops_lie_in_the_band_of_xla_cost_analysis(name):
    ratio = flop_ratio(name)
    assert FLOP_BAND[0] <= ratio <= FLOP_BAND[1], ratio


# ---------------------------------------------------------------------------
# the prefill and decode steps against JAX
# ---------------------------------------------------------------------------
STEP_ARCHS = ["zamba2-7b", "gemma2-9b", "deepseek-v2-lite-16b",
              "musicgen-medium"]


def _leaves(tree):
    return {k: v for k, v in zip(*_paths(tree))}


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        keys, vals = [], []
        for k, v in tree.items():
            ks, vs = _paths(v, f"{prefix}/{k}")
            keys += ks
            vals += vs
        return keys, vals
    return [prefix], [tree]


@pytest.mark.parametrize("name", STEP_ARCHS)
def test_prefill_and_decode_steps_match_jax(name, compute_dtype):
    if compute_dtype == torch.bfloat16:
        return _bf16_steps_match_jax(name)
    jcfg, tcfg = jax_config(name).reduced(), get_config(name).reduced()
    jp = JT.init_params(jcfg, jax.random.PRNGKey(0))
    tp = weights.llm_from_numpy_tree(jax.tree.map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(5)
    b, s = 2, 24
    toks = rng.integers(0, jcfg.vocab_size, (b, s)).astype(np.int32)
    ctx = None
    if jcfg.num_ctx_tokens:
        ctx = (rng.normal(size=(b, jcfg.num_ctx_tokens,
                                jcfg.ctx_dim or jcfg.d_model)) * 0.02
               ).astype(np.float32)
    extra_j = (jnp.asarray(ctx),) if ctx is not None else ()
    extra_t = (torch.as_tensor(ctx),) if ctx is not None else ()

    prefill, pargs, _, _ = specs.make_step(tcfg, ShapeConfig("p", s, b,
                                                             "prefill"))
    assert len(pargs) == 2 + len(extra_t)
    tl, tc = prefill(tp, torch.as_tensor(toks).long(), *extra_t)
    jl, jc = JT.prefill(jcfg, jp, jnp.asarray(toks), JT.init_cache(
        jcfg, b, s), ctx_embed=extra_j[0] if extra_j else None)
    assert tl.shape == (b, tcfg.padded_vocab)
    assert rel_err(tl.numpy(), np.asarray(jl)) <= LLM_RTOL
    got, want = _leaves(tc), _leaves(jax.tree.map(np.asarray, jc))
    assert got.keys() == want.keys()
    for k in want:
        assert rel_err(got[k].numpy(), want[k]) <= LLM_RTOL, k

    # one decode step over a larger cache holding random history
    S, idx = 40, 31
    decode, dargs, _, _ = specs.make_step(tcfg, ShapeConfig("d", S, b,
                                                            "decode"))
    cache_np = {k: (rng.normal(size=tuple(t.shape)) * 0.5).astype(np.float32)
                for k, t in _leaves(dargs[2]).items()}
    jcache = jax.tree.map(lambda x: x, JT.init_cache(jcfg, b, S))
    flat_j = jax.tree_util.tree_flatten_with_path(jcache)
    jcache = jax.tree_util.tree_unflatten(flat_j[1], [
        jnp.asarray(cache_np["".join(f"/{p.key}" for p in path)])
        for path, _ in flat_j[0]])
    tcache = TT.init_cache(tcfg, b, S, "cpu")
    for k, t in _leaves(tcache).items():
        t.copy_(torch.as_tensor(cache_np[k]))
    nxt = rng.integers(0, jcfg.vocab_size, (b, 1)).astype(np.int32)
    tl, tc = decode(tp, torch.as_tensor(nxt).long(), tcache,
                    torch.tensor(idx), *extra_t)
    jl, jc = JT.decode_step(jcfg, jp, jnp.asarray(nxt), jcache,
                            jnp.int32(idx),
                            ctx_embed=extra_j[0] if extra_j else None)
    assert tc is tcache                          # updated in place
    assert rel_err(tl.numpy(), np.asarray(jl)) <= LLM_RTOL
    got, want = _leaves(tc), _leaves(jax.tree.map(np.asarray, jc))
    for k in want:
        assert rel_err(got[k].numpy(), want[k]) <= LLM_RTOL, k


def _bf16_steps_match_jax(name):
    """The bf16 steps: make_step's prefill and decode are the model's own
    bf16 ``prefill`` / ``decode_step`` (bit for bit, caches bf16 but the
    SSM state), and those are held to the JAX package's bf16 steps layer
    by layer (tests/test_torch_bf16.py's walk, BF16_LLM_RTOL)."""
    jcfg, tcfg = jax_config(name).reduced(), get_config(name).reduced()
    bf = torch.bfloat16
    jp = JT.init_params(jcfg, jax.random.PRNGKey(0), jnp.bfloat16)
    tp = weights.llm_from_numpy_tree(jax.tree.map(np.asarray, jp), "cpu",
                                     bf)
    rng = np.random.default_rng(5)
    b, s = 2, 24
    toks = rng.integers(0, jcfg.vocab_size, (b, s)).astype(np.int32)
    ctx = None
    if jcfg.num_ctx_tokens:
        ctx = (rng.normal(size=(b, jcfg.num_ctx_tokens,
                                jcfg.ctx_dim or jcfg.d_model)) * 0.02
               ).astype(np.float32)
    jctx = None if ctx is None else jnp.asarray(ctx)
    tctx = None if ctx is None else torch.as_tensor(ctx).to(bf)
    extra_t = () if ctx is None else (tctx,)
    ttoks = torch.as_tensor(toks).long()

    prefill, pargs, _, _ = specs.make_step(tcfg, ShapeConfig("p", s, b,
                                                             "prefill"))
    assert pargs[0]["final_norm"]["scale"].dtype == bf
    tl, tc = prefill(tp, ttoks, *extra_t)
    with torch.no_grad():
        ol, oc = TT.prefill(tcfg, tp, ttoks, TT.init_cache(tcfg, b, s, "cpu",
                                                           bf),
                            ctx_embed=tctx, dtype=bf)
    assert tl.shape == (b, tcfg.padded_vocab) and torch.equal(tl, ol)
    for k, t in _leaves(tc).items():
        assert t.dtype == (torch.float32 if k.endswith("state") else bf), k
        assert torch.equal(t, _leaves(oc)[k]), k
    assert_layers_match_jax(tcfg, tp, lambda: JT.prefill(
        jcfg, jp, jnp.asarray(toks), JT.init_cache(jcfg, b, s, jnp.bfloat16),
        ctx_embed=jctx, dtype=jnp.bfloat16, unroll_blocks=True,
        impl="ref")[0])

    S, idx = 40, 31
    decode, dargs, _, _ = specs.make_step(tcfg, ShapeConfig("d", S, b,
                                                            "decode"))
    cache_np = {k: (rng.normal(size=tuple(t.shape)) * 0.5).astype(np.float32)
                for k, t in _leaves(dargs[2]).items()}
    flat_j = jax.tree_util.tree_flatten_with_path(
        JT.init_cache(jcfg, b, S, jnp.bfloat16))
    jcache = jax.tree_util.tree_unflatten(flat_j[1], [
        jnp.asarray(cache_np["".join(f"/{p.key}" for p in path)]
                    ).astype(leaf.dtype) for path, leaf in flat_j[0]])
    caches = [TT.init_cache(tcfg, b, S, "cpu", bf) for _ in range(2)]
    for cache in caches:
        for k, t in _leaves(cache).items():
            t.copy_(torch.as_tensor(cache_np[k]))
    nxt = rng.integers(0, jcfg.vocab_size, (b, 1)).astype(np.int32)
    tnxt = torch.as_tensor(nxt).long()
    tl, tc = decode(tp, tnxt, caches[0], torch.tensor(idx), *extra_t)
    with torch.no_grad():
        ol, oc = TT.decode_step(tcfg, tp, tnxt, caches[1], torch.tensor(idx),
                                ctx_embed=tctx, dtype=bf)
    assert tc is caches[0] and torch.equal(tl, ol)
    for k, t in _leaves(tc).items():
        assert torch.equal(t, _leaves(oc)[k]), k
    assert_layers_match_jax(tcfg, tp, lambda: JT.decode_step(
        jcfg, jp, jnp.asarray(nxt), jcache, jnp.int32(idx), ctx_embed=jctx,
        dtype=jnp.bfloat16, unroll_blocks=True, impl="interpret")[0])


# ---------------------------------------------------------------------------
# the dry run
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def zamba2_dryrun(request):
    """(compute dtype, {shape: run_one's dict}): the dry run at bfloat16,
    the reference's compute dtype and the default, and at float32."""
    dtype = getattr(torch, request.param)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(specs, "COMPUTE_DTYPE", dtype)
        return dtype, {s: dryrun.run_one("zamba2-7b", s, device="meta",
                                         verbose=False, save=False)
                       for s in sorted(INPUT_SHAPES)}


@pytest.mark.parametrize("shape", sorted(INPUT_SHAPES))
def test_dryrun_reports_every_shape(zamba2_dryrun, shape):
    dtype, runs = zamba2_dryrun
    r = runs[shape]
    assert r["compute_dtype"] == {torch.float32: "fp32",
                                  torch.bfloat16: "bf16"}[dtype]
    assert r["hlo_flops"] > 0 and r["hlo_bytes"] > 0
    assert r["dominant"] in ("compute", "memory")
    assert r["coll_bytes"] == 0 and r["chips"] == 1
    assert r["t_floor"] == max(r["t_compute"], r["t_memory"])
    assert 0 < r["kernel_plain_flops"] < r["hlo_flops"]
    # the rest at the compute dtype's peak, K6's and K7's products at the
    # bf16 rate on bf16 operands, products with one bf16 operand (K8's
    # besides C B^T) as two TF32 ones, every other product in 3xTF32
    bf16 = r["kernel_products_bf16"]
    x2 = r["kernel_products_tf32x2"]
    assert bf16 == x2 == 0 if dtype == torch.float32 else bf16 > 0
    assert r["t_compute"] == pytest.approx(
        (r["hlo_flops"] - r["kernel_plain_flops"] + r["kernel_other"])
        / H100.peak_flops(r["compute_dtype"])
        + bf16 / H100.peak_flops_bf16
        + (2 * x2 + 3 * (r["kernel_products"] - bf16 - x2))
        / H100.peak_flops_tf32, rel=1e-12)
    assert "card" not in r
    mode = INPUT_SHAPES[shape].mode
    want = {"train": {"ssd_scan", "flash_attention"},
            "prefill": {"ssd_scan", "flash_attention"},
            "decode": {"decode_attention"}}[mode]
    assert set(r["kernel_calls"]) == want


def test_dryrun_fit_flags_match_the_hand_count(zamba2_dryrun):
    dtype, runs = zamba2_dryrun
    size = dtype.itemsize
    cfg = get_config("zamba2-7b")
    params = sch.param_bytes(TT.model_schema(cfg), size)
    moments = sch.param_bytes(TT.model_schema(cfg), 4)       # float32
    # train: the weights, their gradients, both float32 AdamW moments and
    # the new weights alone pass the card (119 GB in fp32, 83.6 GB in
    # bf16), so no batch fits
    assert (3 * size + 8) * cfg.param_count() > H100.hbm_bytes
    train = runs["train_4k"]
    assert not train["fits"] and train["max_batch"] == 0
    # weights, both moments, AdamW's step, int64 tokens and labels
    assert train["arg_bytes"] == params + 2 * moments + 4 \
        + 2 * 8 * 256 * 4096
    # at batch 1 the weights, gradients, moments and new weights are live
    assert train["batch1_peak_bytes"] > 3 * params + 2 * moments
    # decode: the weights and one 32k-slot cache per slot; nothing else
    # of size stays live, so the batch is what the card holds of slots
    slot = profile.kv_cache_bytes(cfg, 1, 32768, size)
    hand = int((H100.hbm_bytes - params) // slot)
    dec = runs["decode_32k"]
    assert not dec["fits"] and dec["max_batch"] == hand >= 2
    assert dec["arg_bytes"] == params + 128 * slot + 128 * 8 + 8
    assert dec["output_bytes"] < 1e8                 # the cache is in place
    # long_500k: a 524,288-slot cache of one slot does not fit
    lng = runs["long_500k"]
    assert lng["max_batch"] == 0
    assert lng["batch1_peak_bytes"] == lng["peak_memory_per_device"]
    assert params + profile.kv_cache_bytes(cfg, 1, 524288, size) \
        > H100.hbm_bytes


def test_dryrun_prefill_peak_holds_no_score_matrix(zamba2_dryrun,
                                                   monkeypatch):
    # K6's plain version would hold b x 32 heads x s x s values (137 GB a
    # row at 32k in fp32); the kernel region leaves it out of the peak
    dtype, runs = zamba2_dryrun
    monkeypatch.setattr(specs, "COMPUTE_DTYPE", dtype)
    cfg = get_config("zamba2-7b")
    r = runs["prefill_32k"]
    s = INPUT_SHAPES["prefill_32k"].seq_len
    scores = dtype.itemsize * cfg.num_heads * s * s
    assert r["kernel_calls"] == {"ssd_scan": 71, "flash_attention": 10}
    assert 1 <= r["max_batch"] < 32
    cut = dryrun.abstract_pass(cfg, dataclasses.replace(
        INPUT_SHAPES["prefill_32k"], global_batch=1), "zamba2-7b")
    assert cut.peak_memory_per_device < min(scores, H100.hbm_bytes)
    assert cut.peak_memory_per_device > cut.arg_bytes + cut.output_bytes


def test_dryrun_floor_charges_the_kernels_own_work(zamba2_dryrun):
    # prefill_32k: K6's causal pairs (not the plain s x s) in 10 calls and
    # K8's chunked scan in 71, K8's products in 3xTF32 and K6's too on
    # float32, K6's and K8's C B^T at the bf16 rate on bf16 and K8's other
    # products as two TF32 ones; the floor is below the plain program's
    # FLOPs at the compute dtype's rate
    dtype, runs = zamba2_dryrun
    cfg = get_config("zamba2-7b")
    r = runs["prefill_32k"]
    shape = INPUT_SHAPES["prefill_32k"]
    b, s = shape.global_batch, shape.seq_len
    k6 = fa.pair_work(b * cfg.num_heads * s * (s + 1) // 2, cfg.head_dim,
                      cfg.head_dim, None)
    k8 = sk.chunked_ops(b, s, cfg.n_ssm_heads, cfg.ssm_head_dim,
                        cfg.ssm_state, cfg.ssm_chunk)
    assert r["kernel_products"] == 10 * k6[0] + 71 * k8[0]
    assert r["kernel_products_bf16"] == (10 * k6[0] + 71 * k8[2]
                                         if dtype == torch.bfloat16 else 0)
    assert r["kernel_products_tf32x2"] == (71 * (k8[0] - k8[2])
                                           if dtype == torch.bfloat16 else 0)
    assert r["kernel_other"] == 10 * k6[1] + 71 * k8[1]
    assert r["kernel_plain_flops"] > 10 * 2 * k6[0]       # the full s x s
    assert r["t_compute"] < r["hlo_flops"] / H100.peak_flops(
        r["compute_dtype"])
    # the cut batch's floor is what the card pass is held to: in fp32 the
    # GEMMs' FLOPs at 67 TFLOP/s bound it, in bf16 (989.4 TFLOP/s) the
    # eager program's bytes
    assert r["cut_t_floor"] < r["t_floor"]
    assert r["cut_dominant"] == ("memory" if dtype == torch.bfloat16
                                 else "compute")
    assert 0 < r["cut_peak_bytes"] <= H100.hbm_bytes


def test_dryrun_cli_and_multi_pod(capsys, monkeypatch, tmp_path):
    monkeypatch.setattr(dryrun, "ARTIFACT_DIR", str(tmp_path))
    dryrun.main(["--arch", "mamba2-2.7b", "--shape", "long_500k",
                 "--device", "meta"])
    out = capsys.readouterr().out
    assert "mamba2-2.7b x long_500k" in out and "fits=True" in out
    assert (tmp_path / "mamba2-2.7b_long_500k_h100.json").exists()
    with pytest.raises(NotImplementedError, match="512 chips"):
        dryrun.run_one("zamba2-7b", "decode_32k", device="meta",
                       multi_pod=True)
    with pytest.raises(ValueError, match="cuda or meta"):
        dryrun.run_one("zamba2-7b", "decode_32k", device="cpu")


def test_dryrun_card_pass_needs_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        dryrun.run_one("mamba2-2.7b", "long_500k", save=False,
                       verbose=False)


def test_profile_cli_prints_every_shape(capsys, compute_dtype):
    profile.main(["--arch", "zamba2-7b"])
    out = capsys.readouterr().out
    assert {torch.float32: "weights fp32 23.9 GB",
            torch.bfloat16: "weights bf16 11.9 GB"}[compute_dtype] in out
    for shape in INPUT_SHAPES:
        assert shape in out


if __name__ == "__main__":
    # the FLOP ratios against XLA, one line per arch:
    #   JAX_PLATFORMS=cpu PYTHONPATH=src python tests/test_torch_dryrun.py
    for arch in list_archs():
        print(f"{arch}: {flop_ratio(arch):.4f}")
