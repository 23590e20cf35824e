"""The port's TPU-pod tooling against the JAX package's, on the CPU: the
sharding rules and every spec helper, the abstract (meta) shapes of
parameters, caches and inputs at full width for every arch, the pure
functions ``model_flops``, ``kv_cache_bytes`` and ``collective_bytes``, and
the sharding hooks' calls.

``PartitionSpec``s are compared as tuples (both packages normalise a
one-axis tuple to its axis).  Dtypes map float32 -> torch.float32, bfloat16
-> torch.bfloat16, and the reference's int32 tokens and cache index to the
port's index dtype (``specs.INDEX_DTYPE``, int64).  Nothing is allocated
on either side: JAX's trees are ``ShapeDtypeStruct``s, the port's meta
tensors."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import INPUT_SHAPES as J_SHAPES
from repro.configs import get_config as jax_config
from repro.launch import profile as jprofile
from repro.launch import specs as jspecs
from repro.models import sharding as jshd
from repro.models import stubs as jstubs
from repro.models import transformer as JT
from repro.roofline import analysis as janalysis
from repro_torch import weights
from repro_torch.configs import INPUT_SHAPES, get_config, list_archs
from repro_torch.launch import profile as tprofile
from repro_torch.launch import specs as tspecs
from repro_torch.models import sharding as tshd
from repro_torch.models import stubs as tstubs
from repro_torch.models import transformer as TT
from repro_torch.roofline import analysis as tanalysis
from repro_torch.testing import LLM_RTOL, rel_err

torch.set_num_threads(1)

ARCHS = list_archs()
SHAPES = sorted(INPUT_SHAPES)
DTYPES = {jnp.dtype(jnp.float32): torch.float32,
          jnp.dtype(jnp.bfloat16): torch.bfloat16,
          jnp.dtype(jnp.int32): tspecs.INDEX_DTYPE}


def flat(tree, prefix=""):
    """{path: leaf} of nested dicts (and NamedTuples by field)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}/{k}"))
        return out
    if hasattr(tree, "_fields"):
        out = {}
        for k in tree._fields:
            out.update(flat(getattr(tree, k), f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def assert_same_specs(got, want):
    g, w = flat(got), flat(want)
    assert g.keys() == w.keys()
    for k in w:
        assert isinstance(g[k], tshd.PartitionSpec), k
        assert tuple(g[k]) == tuple(w[k]), (k, g[k], w[k])


def assert_same_abstract(got, want, dtype_map=DTYPES):
    g, w = flat(got), flat(want)
    assert g.keys() == w.keys()
    for k in w:
        assert g[k].is_meta, k
        assert tuple(g[k].shape) == tuple(w[k].shape), k
        assert g[k].dtype == dtype_map[jnp.dtype(w[k].dtype)], k


# ---------------------------------------------------------------------------
# rules and spec helpers
# ---------------------------------------------------------------------------
RULE_CASES = [(s, mp, None) for s in SHAPES for mp in (False, True)] + [
    ("train_4k", False, {"act_seq": "model", "fsdp_gather_at_use": True}),
    ("decode_32k", True, {"cache_seq": ("data", "model"), "embed": None})]


@pytest.mark.parametrize("shape, multi_pod, overrides", RULE_CASES)
def test_default_rules_and_spec_helpers_match_jax(shape, multi_pod,
                                                  overrides):
    want = jshd.default_rules(J_SHAPES[shape], multi_pod=multi_pod,
                              overrides=overrides)
    got = tshd.default_rules(INPUT_SHAPES[shape], multi_pod=multi_pod,
                             overrides=overrides)
    assert got == want
    for fn in ("activation_spec", "token_spec", "ctx_spec", "logits_spec"):
        spec = getattr(tshd, fn)(got)
        assert isinstance(spec, tshd.PartitionSpec)
        assert tuple(spec) == tuple(getattr(jshd, fn)(want)), fn


def test_partition_spec_normalises_as_jax_does():
    from jax.sharding import PartitionSpec as P
    for entries in [(), (None,), (("data",),), (("pod", "data"), None),
                    ((), "model"), ("data", None, "model")]:
        assert tuple(tshd.PartitionSpec(*entries)) == tuple(P(*entries))
    assert repr(tshd.PartitionSpec("data")) == "PartitionSpec('data',)"


@pytest.mark.parametrize("arch", ARCHS)
def test_param_unit_and_cache_specs_match_jax(arch):
    jcfg, tcfg = jax_config(arch), get_config(arch)
    for shape in SHAPES:
        rules = jshd.default_rules(J_SHAPES[shape])
        assert_same_specs(TT.param_partition_specs(tcfg, rules),
                          JT.param_partition_specs(jcfg, rules))
        # the two-level FSDP gather's use-site specs (embed unsharded)
        use = dict(rules, fsdp_gather_at_use=True, embed=None)
        assert_same_specs(TT.block_unit_specs(tcfg, use),
                          JT.block_unit_specs(jcfg, use))
        sh = INPUT_SHAPES[shape]
        assert_same_specs(
            TT.cache_partition_specs(tcfg, sh.global_batch, sh.seq_len,
                                     rules),
            JT.cache_partition_specs(jcfg, sh.global_batch, sh.seq_len,
                                     rules))


# ---------------------------------------------------------------------------
# abstract shapes at full width
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_params_cache_and_inputs_match_jax(arch):
    # the defaults are the reference's (bfloat16), and an explicit float32
    # gives float32 on both sides
    jcfg, tcfg = jax_config(arch), get_config(arch)
    assert_same_abstract(TT.abstract_params(tcfg, torch.float32),
                         JT.abstract_params(jcfg, jnp.float32))
    assert_same_abstract(TT.abstract_params(tcfg), JT.abstract_params(jcfg))
    # the SSM state stays float32 under a bfloat16 cache
    assert_same_abstract(TT.abstract_cache(tcfg, 3, 128),
                         JT.abstract_cache(jcfg, 3, 128))
    assert_same_abstract(TT.abstract_cache(tcfg, 3, 128, torch.float32),
                         JT.abstract_cache(jcfg, 3, 128, jnp.float32))
    for shape in SHAPES:
        jc = jspecs.arch_for_shape(jcfg, J_SHAPES[shape])
        tc = tspecs.arch_for_shape(tcfg, INPUT_SHAPES[shape])
        assert tc.name == jc.name
        assert_same_abstract(tspecs.input_specs(tc, INPUT_SHAPES[shape]),
                             jspecs.input_specs(jc, J_SHAPES[shape]))
        assert_same_abstract(tspecs.input_specs(tc, INPUT_SHAPES[shape],
                                                dtype=torch.float32),
                             jspecs.input_specs(jc, J_SHAPES[shape],
                                                dtype=jnp.float32))
    if tcfg.num_ctx_tokens:
        for got, want in ((tstubs.frontend_spec(tcfg, 5),
                           jstubs.frontend_spec(jcfg, 5)),
                          (tstubs.frontend_spec(tcfg, 5, torch.float32),
                           jstubs.frontend_spec(jcfg, 5, jnp.float32))):
            assert got.is_meta and tuple(got.shape) == want.shape
            assert got.dtype == DTYPES[jnp.dtype(want.dtype)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_make_step_abstract_args_and_specs_follow_the_reference(
        monkeypatch, dtype):
    # the train step's arguments (params, AdamW state, batch) and specs,
    # and the decode step's cache and index, have the reference's trees,
    # at the compute dtype make_step reads (bfloat16 as the reference's;
    # float32 where a caller sets it)
    tdtype, jdtype = getattr(torch, dtype), getattr(jnp, dtype)
    monkeypatch.setattr(tspecs, "COMPUTE_DTYPE", tdtype)
    tcfg = get_config("deepseek-v2-lite-16b")
    jcfg = jax_config("deepseek-v2-lite-16b")
    sh = INPUT_SHAPES["train_4k"]
    rules = tshd.default_rules(sh)
    _, args, in_specs, out_specs = tspecs.make_step(tcfg, sh, rules)
    assert_same_abstract(args[0], JT.abstract_params(jcfg, jdtype))
    # AdamW's moments are float32 whatever the parameters' dtype
    moments = JT.abstract_params(jcfg, jnp.float32)
    assert_same_abstract(args[1].mu, moments)
    assert_same_abstract(args[1].nu, moments)
    assert args[1].step.dtype == torch.int32 and args[1].step.is_meta
    assert set(args[2]) == {"tokens", "labels"}
    assert tuple(in_specs[2]["tokens"]) == tuple(jshd.token_spec(rules))
    assert_same_specs(in_specs[1].nu, JT.param_partition_specs(jcfg, rules))
    assert tuple(out_specs[2]) == ()

    sh = INPUT_SHAPES["decode_32k"]
    rules = tshd.default_rules(sh)
    _, args, in_specs, out_specs = tspecs.make_step(tcfg, sh, rules)
    assert_same_abstract(args[2], jspecs.input_specs(
        jcfg, J_SHAPES["decode_32k"], dtype=jdtype)["cache"])
    assert tuple(args[3].shape) == () and args[3].is_meta
    assert_same_specs(in_specs[2], JT.cache_partition_specs(
        jcfg, sh.global_batch, sh.seq_len, rules))
    assert tuple(out_specs[0]) == (None, None, "model")


# ---------------------------------------------------------------------------
# pure functions
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_and_kv_cache_bytes_equal_jax(arch):
    for shape in SHAPES:
        jc = jspecs.arch_for_shape(jax_config(arch), J_SHAPES[shape])
        tc = tspecs.arch_for_shape(get_config(arch), INPUT_SHAPES[shape])
        sh = INPUT_SHAPES[shape]
        assert tanalysis.model_flops(tc, sh) == janalysis.model_flops(
            jc, J_SHAPES[shape])
        for bytes_per in (2, 4):
            assert tprofile.kv_cache_bytes(
                tc, sh.global_batch, sh.seq_len, bytes_per) == \
                jprofile.kv_cache_bytes(jc, sh.global_batch, sh.seq_len,
                                        bytes_per)


HLO = """
  %ag = f32[16,4096]{1,0} all-gather(f32[1,4096]{1,0} %p), replica_groups={{0,1,2,3,4,5,6,7,8,9,10,11,12,13,14,15}}, dimensions={0}
  %ar = bf16[1024,512]{1,0} all-reduce(bf16[1024,512]{1,0} %x), replica_groups=[16,16]<=[256], to_apply=%add
  %rs = f32[64,128]{1,0} reduce-scatter(f32[1024,128]{1,0} %y), replica_groups={{0,1}}, dimensions={0}
  %a2a = (f32[8,32]{1,0}, f32[8,32]{1,0}) all-to-all(f32[8,32]{1,0} %a, f32[8,32]{1,0} %b), replica_groups={{0,1,2,3}}
  %cp = s32[128]{0} collective-permute(s32[128]{0} %z), source_target_pairs={{0,1},{1,0}}
  %ags = (f32[4,8]{1,0}, f32[32,8]{1,0}) all-gather-start(f32[4,8]{1,0} %q), replica_groups=[32,8]<=[256]
  %agd = f32[32,8]{1,0} all-gather-done((f32[4,8]{1,0}, f32[32,8]{1,0}) %ags)
  %ars = f32[256]{0} all-reduce-start(f32[256]{0} %r), replica_groups={{0,1,2,3,4,5,6,7}}
  %ard = f32[256]{0} all-reduce-done(f32[256]{0} %ars)
  %add = f32[8]{0} add(f32[8]{0} %u, f32[8]{0} %v)
  %ag2 = u8[100]{0} all-gather(u8[50]{0} %w)
"""


@pytest.mark.parametrize("text", [HLO, "", HLO.replace("bf16", "f16")])
def test_collective_bytes_equals_jax(text):
    got_total, got_kinds = tanalysis.collective_bytes(text)
    want_total, want_kinds = janalysis.collective_bytes(text)
    assert got_kinds == want_kinds
    assert got_total == want_total
    if text:
        assert set(got_kinds) == {"all-gather", "all-reduce",
                                  "reduce-scatter", "all-to-all",
                                  "collective-permute"}


# ---------------------------------------------------------------------------
# the sharding hooks
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["zamba2-7b", "qwen3-moe-235b-a22b"])
def test_sharding_hooks_see_the_references_calls(name):
    # a recording act_constraint (MoE's constrain too) and
    # block_param_constraint passed to both packages' forward see the same
    # (kind, shape) sequence; the port's logits are unchanged by them
    jcfg, tcfg = jax_config(name).reduced(), get_config(name).reduced()
    jp = JT.init_params(jcfg, jax.random.PRNGKey(0))
    tp = weights.llm_from_numpy_tree(jax.tree.map(np.asarray, jp), "cpu")
    toks = np.random.default_rng(3).integers(
        0, jcfg.vocab_size, (2, 16)).astype(np.int32)
    calls = {"jax": [], "port": []}

    def recorder(side):
        def act(x, kind="residual"):
            calls[side].append((kind, tuple(x.shape)))
            return x

        def block(bp):
            calls[side].append(("block", len(flat(bp))))
            return bp
        return act, block

    act, block = recorder("jax")
    jl, _, _ = JT.forward(jcfg, jp, jnp.asarray(toks), act_constraint=act,
                          block_param_constraint=block, unroll_blocks=True)
    act, block = recorder("port")
    tl, _, _ = TT.forward(tcfg, tp, torch.as_tensor(toks),
                          act_constraint=act, block_param_constraint=block)
    assert calls["port"] == calls["jax"]
    kinds = {k for k, _ in calls["port"]}
    assert "residual" in kinds and "block" in kinds
    if tcfg.num_experts:
        assert {"moe_tokens", "moe_buffer", "expert", "expert_ff"} <= kinds
    assert rel_err(tl.detach().numpy(), np.asarray(jl)) <= LLM_RTOL
    plain, _, _ = TT.forward(tcfg, tp, torch.as_tensor(toks))
    assert torch.equal(plain, tl)
