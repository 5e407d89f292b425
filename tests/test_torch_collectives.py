"""The port's collectives (``repro_torch.analysis.collectives``) against
the reference's ``repro.analysis.hlo`` and hand counts:

* ``_wire_bytes`` equals the reference's for every op and every group
  size in {1, 2, 4, 16, 512}; ``summarize`` and ``collective_bytes``
  equal the reference's on the same records (the reference's records
  parsed from an HLO fixture);
* ``step_collectives`` on reduced configs over a 2 x 4 (data, model)
  descriptor, counted by hand: a 2-layer dense arch under tensor
  parallelism (``intra``), an MoE arch under expert pools, ``fsdp``,
  ``seq_shard`` and ``cp``; a head count the model axis does not divide
  makes no attention traffic.
"""

import math

import pytest

pytest.importorskip("torch")

from repro.analysis import hlo  # noqa: E402
from repro_torch.analysis import collectives as coll  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.core import tuner  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.models import model_defs, module  # noqa: E402

OPS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
       "collective-permute")
GROUPS = (1, 2, 4, 16, 512)

FIXTURE = """
HloModule jit_step
%x = f32[16,4096,2048]{2,1,0} all-reduce(%y), channel_id=3, replica_groups=[16,16]<=[256], to_apply=%add
%g = bf16[2048,92544]{0,1} all-gather(%w), channel_id=4, replica_groups=[16,16]<=[16,16]T(1,0), dimensions={0}
%rs = bf16[16,256,2048]{2,1,0} reduce-scatter(%z), channel_id=5, replica_groups=[64,4]<=[256], dimensions={1}, to_apply=%add
%a2a = (f32[16,256,128]{2,1,0}, f32[16,256,128]{2,1,0}) all-to-all(%p, %q), channel_id=6, replica_groups={{0,1,2,3},{4,5,6,7}}
%cp = bf16[8,128]{1,0} collective-permute(%r), channel_id=7, source_target_pairs={{0,1},{1,0}}
%ar2 = bf16[512]{0} all-reduce(%s), channel_id=8, replica_groups=[1,512]<=[512], to_apply=%add
"""

MESH = mesh_lib.MeshDescriptor(("data", "model"), (2, 4))
TRAIN = ShapeConfig("t", "train", 8, 4)     # B 4 over data 2: T = 16
PREFILL = ShapeConfig("p", "prefill", 8, 4)
D = 64                                      # reduced()'s d_model
ACT = 2 * 8 * D * 2                         # [T=16, D] bf16


def _rules(plan, mesh=MESH):
    return tuner.make_rules(plan, mesh)


def _ops(colls):
    out = {}
    for c in colls:
        out.setdefault(c.op, []).append(c)
    return out


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("n", GROUPS)
def test_wire_bytes_equal_the_reference(op, n):
    for payload in (0.0, 1.0, 4096.0, 3.5e9):
        assert coll._wire_bytes(op, payload, n) == \
            hlo._wire_bytes(op, payload, n)


def test_summarize_equals_the_reference_on_parsed_records():
    ref = hlo.parse_collectives(FIXTURE)
    ours = [coll.collective(c.op, c.bytes_payload, c.group_size, c.line)
            for c in ref]
    assert [c.wire_bytes for c in ours] == [c.wire_bytes for c in ref]
    assert coll.summarize(ours) == hlo.summarize(ref)
    assert coll.collective_bytes(ours) == hlo.collective_bytes(FIXTURE)


def _grad_bytes(cfg, sharded):
    """Hand count: each weight's elements over 4 where one of its axes in
    ``sharded`` splits over the model axis, bf16."""
    total = 0
    for d in module.tree_leaves(
            model_defs(cfg), is_leaf=lambda x: isinstance(x, module.ParamDef)):
        div = 4 if any(a in sharded and n % 4 == 0
                       for a, n in zip(d.axes, d.shape)) else 1
        total += math.prod(d.shape) // div * 2
    return total


def test_dense_tensor_parallel_by_hand():
    cfg = reduced(get_config("internlm2-1.8b"))      # 2 layers, 4:2 heads
    plan = tuner.Plan("tp", data=2, pools=1, intra=4, seq_shard=False)
    got = coll.step_collectives(cfg, TRAIN, plan, _rules(plan))
    ops = _ops(got)
    # per layer attention and mlp, forward and backward; the embedding
    # lookup and the head's backward: all-reduces of [T, D]
    big = [c for c in ops["all-reduce"] if c.bytes_payload == ACT]
    assert len(big) == 2 * 2 * 2 + 2
    assert all(c.group_size == 4 for c in big)
    # the vocab-sharded softmax: max, sum and the label's logit, fp32 [T]
    small = [c for c in ops["all-reduce"] if c.bytes_payload == 16 * 4]
    assert len(small) == 3
    # ZeRO-1 over the data axis: grads reduce-scattered, params gathered
    grads = _grad_bytes(cfg, {module.HEADS, module.MLP, module.VOCAB})
    (rs,), (ag,) = ops["reduce-scatter"], ops["all-gather"]
    assert (rs.bytes_payload, rs.group_size) == (grads / 2, 2)
    assert (ag.bytes_payload, ag.group_size) == (grads, 2)
    assert rs.wire_bytes == grads / 2 and ag.wire_bytes == grads / 2
    assert set(ops) == {"all-reduce", "reduce-scatter", "all-gather"}
    assert all("over model (4)" in c.line for c in big)


def test_unsplit_heads_make_no_attention_traffic():
    cfg = reduced(get_config("internlm2-1.8b"), heads=2, kv_heads=1)
    plan = tuner.Plan("tp", data=2, pools=1, intra=4, seq_shard=False)
    got = coll.step_collectives(cfg, PREFILL, plan, _rules(plan))
    assert not [c for c in got if "attn" in c.line]
    # the mlp's all-reduce a layer, the lookup's, the logits' gather
    assert len([c for c in got if "mlp" in c.line]) == 2
    (gather,) = [c for c in got if c.op == "all-gather"]
    assert gather.bytes_payload == 2 * 256 * 4 and gather.group_size == 4


def test_seq_shard_splits_each_all_reduce():
    cfg = reduced(get_config("internlm2-1.8b"))
    plan = tuner.Plan("sp", data=2, pools=1, intra=4, seq_shard=True)
    ops = _ops(coll.step_collectives(cfg, TRAIN, plan, _rules(plan)))
    blocks = [c for c in ops["all-gather"] if "layer" in c.line]
    scatters = [c for c in ops["reduce-scatter"] if "layer" in c.line]
    assert len(blocks) == len(scatters) == 2 * 2 * 2
    assert all(c.bytes_payload == ACT for c in blocks)
    assert all(c.bytes_payload == ACT / 4 for c in scatters)
    # the ring bytes of a gather and a scatter equal one all-reduce's
    assert blocks[0].wire_bytes + scatters[0].wire_bytes == \
        coll._wire_bytes("all-reduce", ACT, 4)


def test_expert_pools_all_to_all():
    cfg = reduced(get_config("dbrx-132b"))           # 4 experts, top 4
    plan = tuner.Plan("ep", data=2, pools=4, intra=1, seq_shard=False)
    ops = _ops(coll.step_collectives(cfg, TRAIN, plan, _rules(plan)))
    a2a = ops["all-to-all"]
    # dispatch and combine, forward and backward, each MoE layer
    assert len(a2a) == 2 * 2 * 2
    k = cfg.moe.top_k
    assert all(c.bytes_payload == 16 * k * D * 2 and c.group_size == 4
               for c in a2a)
    assert all(c.wire_bytes == c.bytes_payload * 3 / 4 for c in a2a)


def test_fsdp_gathers_params_per_step():
    cfg = reduced(get_config("internlm2-1.8b"))
    plan = tuner.Plan("fsdp", data=2, pools=1, intra=4, fsdp=True,
                      seq_shard=False)
    ops = _ops(coll.step_collectives(cfg, TRAIN, plan, _rules(plan)))
    grads = _grad_bytes(cfg, {module.HEADS, module.MLP, module.VOCAB})
    fs = [c for c in ops["all-gather"] if "fsdp" in c.line]
    assert [c.bytes_payload for c in fs] == [grads, grads]  # fwd, bwd
    (rs,) = ops["reduce-scatter"]
    assert rs.bytes_payload == grads / 2 and "fsdp grads" in rs.line
    # serving gathers once and scatters nothing
    ops = _ops(coll.step_collectives(cfg, PREFILL, plan, _rules(plan)))
    assert len([c for c in ops["all-gather"] if "fsdp" in c.line]) == 1
    assert "reduce-scatter" not in ops


def test_context_parallel_gathers_kv():
    cfg = reduced(get_config("internlm2-1.8b"))
    plan = tuner.Plan("cp", data=2, pools=1, intra=4, cp=True,
                      seq_shard=False)
    got = coll.step_collectives(cfg, TRAIN, plan, _rules(plan))
    kv = [c for c in got if " cp " in c.line]
    # K and V, forward and backward, each of the 2 attention layers
    assert len(kv) == 2 * 2 * 2
    want = 2 * 8 * cfg.num_kv_heads * cfg.resolved_head_dim * 2
    assert all(c.op == "all-gather" and c.bytes_payload == want
               and c.group_size == 4 for c in kv)
    # heads are not split under cp: no attention all-reduce; the weights,
    # sharded over every axis, are gathered over all 8 devices
    assert not [c for c in got if "attn:" in c.line]
    params = [c for c in got if "cp params" in c.line]
    assert len(params) == 2 and all(c.group_size == 8 for c in params)
    assert params[0].bytes_payload == _grad_bytes(cfg, set())
