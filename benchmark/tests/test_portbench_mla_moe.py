"""The ``moonlight-ep8`` configuration's pieces on the CPU: its flops file
against a hand count at a small shape and against the parameters the
family draws, the configuration's cut (``reduced``, ``cut``,
``assumed``), the architecture the program builds from it under the
preset's TRPO block, and the
three readers that read the family's spans and tallies."""

from types import SimpleNamespace

import pytest
import torch

from benchmark import spans
from benchmark.spec import HERE, load_json, load_module, metric_reader

CONFIG = load_json(HERE / "configs" / "moonlight-ep8.json")
# hidden 8, 2 heads of nope 2 / rope 2 / v 2, kv rank 4, dense width 6,
# expert width 3, 2 experts held of a router of 4, top-2, 1 shared,
# vocab 5, one dense and one expert layer, 4 positions
SMALL = dict(CONFIG, hidden_size=8, num_attention_heads=2,
             qk_nope_head_dim=2, qk_rope_head_dim=2, v_head_dim=2,
             kv_lora_rank=4, intermediate_size=6, moe_intermediate_size=3,
             n_routed_experts=2, num_experts_per_tok=2, n_shared_experts=1,
             vocab_size=5, num_hidden_layers=2, seq_len=4,
             deployment=dict(CONFIG["deployment"], router_experts=4,
                             held_experts=[0, 1]))


def test_flops_by_hand():
    f = load_module("flops", "mla_moe")
    # attention weights: 8·2·4 + 8·6 + 4·2·4 + 2·2·8 = 176 a layer
    assert f.mla_ops(SMALL, 4) == 2 * 4 * 176 + 2 * 2 * 6 * 10
    assert f.mla_bytes(SMALL, 4) == 4 * (176 + 4 + 2 * 4 * 8)
    dense, head = 6 * 4 * 8 * 6, 2 * 4 * 8 * 5
    router, shared = 2 * 4 * 8 * 4, 6 * 4 * 8 * 3
    routed = 6 * (4 * 2 * 2 // 4) * 8 * 3      # 4 expert rows of 8 slots
    assert f.forward(SMALL, 1) == (2 * f.mla_ops(SMALL, 4) + dense + head
                                   + router + shared + routed)
    assert f.gradient(SMALL, 3) == 3 * f.forward(SMALL, 3)
    assert f.fvp(SMALL, 3) == 4 * f.forward(SMALL, 3)
    assert f.expert_ops(SMALL, 5) == 6 * 5 * 8 * 3
    assert f.expert_bytes(SMALL, [5, 0]) == 4 * (3 * 8 * 3 + 2 * 5 * 8)


@pytest.mark.parametrize("config", [SMALL, CONFIG], ids=["small", "moonlight"])
def test_n_params_is_what_the_family_draws(config):
    f = load_module("flops", "mla_moe")
    fam = load_module("families", "mla_moe")
    assert f.n_params(config) == sum(
        torch.Size(s).numel() for s in fam._shapes(config).values())


def test_moonlight_counts():
    f = load_module("flops", "mla_moe")
    assert f.n_params(CONFIG) == 568_484_352           # 2.27 GB in f32
    assert f.forward(CONFIG, 1) == 1_236_466_139_136   # 0.604 GFLOP a position


def test_the_cut_and_the_assumptions_are_stated():
    bench = load_json(HERE.parent / "BENCHMARK.json")
    entry = {c["name"]: c for c in bench["configs"]}["moonlight-ep8"]
    assert CONFIG["reduced"] == entry["reduced"] == [
        "num_hidden_layers", "n_routed_experts", "vocab_size"]
    assert CONFIG["source"] == entry["source"]
    for key, published in (("num_hidden_layers", "27"),
                           ("n_routed_experts", "64"),
                           ("vocab_size", "163,840")):
        assert published in CONFIG["cut"][key] and "8" in CONFIG["cut"][key]
    assert (CONFIG["num_hidden_layers"], CONFIG["n_routed_experts"],
            CONFIG["vocab_size"]) == (5, 8, 20480)
    dep = CONFIG["deployment"]
    assert dep["chips_per_layer"] == 8 and dep["router_experts"] == 64
    assert dep["held_experts"] == list(range(8))
    assert set(CONFIG["assumed"]) == {"weights", "kv_lora_norm_eps", "text",
                                      "actions", "trpo"}
    # every published width as Moonlight's config.json states it
    for key, value in dict(hidden_size=2048, intermediate_size=11264,
                           moe_intermediate_size=1408, kv_lora_rank=512,
                           q_lora_rank=None, qk_nope_head_dim=128,
                           qk_rope_head_dim=64, v_head_dim=128,
                           num_attention_heads=16, num_experts_per_tok=6,
                           n_shared_experts=2, first_k_dense_replace=1,
                           routed_scaling_factor=2.446, rope_theta=50000,
                           rms_norm_eps=1e-5).items():
        assert CONFIG[key] == value, key


def test_the_configuration_runs_the_presets_architecture():
    """The program runs the configuration's widths (its one source) under
    the preset's TRPO block."""
    from trpo_torch.config import get_preset

    fam = load_module("families", "mla_moe")
    arch = fam.architecture(CONFIG)
    for key in ("hidden_size", "num_hidden_layers", "first_k_dense_replace",
                "num_attention_heads", "qk_nope_head_dim",
                "qk_rope_head_dim", "v_head_dim", "kv_lora_rank",
                "intermediate_size", "moe_intermediate_size",
                "num_experts_per_tok", "n_shared_experts",
                "routed_scaling_factor", "norm_topk_prob", "vocab_size",
                "rms_norm_eps"):
        assert getattr(arch, key) == CONFIG[key], key
    assert arch.router_experts == CONFIG["deployment"]["router_experts"]
    assert arch.held_experts == tuple(CONFIG["deployment"]["held_experts"])
    assert arch.rope_theta == CONFIG["rope_theta"]
    preset = get_preset(CONFIG["preset"])
    for key, value in CONFIG["trpo"].items():
        assert getattr(preset, key) == value, key


def _ctx():
    return SimpleNamespace(config=CONFIG, flops=load_module("flops",
                                                            "mla_moe"),
                           peak={"tf32_flops": 495e12,
                                 "hbm_bytes_per_s": 3.35e12})


class _Rec:
    def __init__(self, name, ms):
        self.name, self.ms = name, ms

    def device_ms(self):
        return self.ms


@pytest.fixture
def program():
    from trpo_torch.ops import _build

    _build.reset_launches()
    yield _build
    _build.reset_launches()


def _fill(program):
    program.SPAN_COUNTS["trpo/grad_and_surrogate"] = 1
    program.SPANS.records.extend([_Rec("policy/mla", 2.0),
                                  _Rec("policy/mla", 1.0),
                                  _Rec("policy/moe/experts", 1.0)])
    program.TALLIES["policy/mla"] += [(16384, 1), (2048, 2)]
    program.TALLIES["policy/moe/experts"] += [([3000, 1000, 0, 0, 0, 0, 0,
                                                0], 1)]


def test_readers_of_the_family_spans(program):
    ctx = _ctx()
    f = ctx.flops
    for name in ("mla.roofline", "moe.roofline", "expert_imbalance"):
        assert metric_reader(name).read(ctx) is None   # nothing recorded
    _fill(program)
    assert spans.stretch() is not None
    shares = [max(f.mla_ops(CONFIG, p) / 495e12,
                  f.mla_bytes(CONFIG, p) / 3.35e12) * n / (ms * 1e-3)
              for (p, n), ms in zip(program.TALLIES["policy/mla"],
                                       (2.0, 1.0))]
    got = metric_reader("mla.roofline").read(ctx)
    assert got == pytest.approx(100 * sum(shares) / 2)
    assert 0 < metric_reader("moe.roofline").read(ctx) <= 100
    # 3,000 of 4,000 tokens on one of 8 experts: 6 times the mean
    assert metric_reader("expert_imbalance").read(ctx) == pytest.approx(6.0)
    program.TALLIES["policy/mla"].pop()                  # out of step
    assert metric_reader("mla.roofline").read(ctx) is None


def test_readers_of_an_older_program(program, monkeypatch):
    _fill(program)
    with monkeypatch.context() as m:
        m.delattr(program, "TALLIES")
        for name in ("mla.roofline", "moe.roofline", "expert_imbalance"):
            assert metric_reader(name).read(_ctx()) is None
