"""The benchmark's reference of the published Zamba2 block
(`reference/zamba2.py`) and the cell that runs it: the reference held
to transformers' `Zamba2ForCausalLM` (the published forward) at a tiny
random size, layer by layer and in logits; its parameter and FLOP counts
pinned at the published widths to a count by hand; each new per-layer
reader on a trace made by hand; the prefill cell run whole on the CPU at
a small size, and a training cell of a 13-layer stage, which the
benchmark does not list, made in the test's own tree; and the reference
imports nothing of the program."""
import json
import math
import subprocess
import sys

import pytest
import torch

import portbench_small
from portbench_small import ROOT, run_small, small_tree, one_thread  # noqa: F401
from portbench import check, harness
from portbench import tracing as tr
from portbench.reference import zamba2 as ref

PREFILL = "zamba2-7b-instruct.prefill-4x2048"
TRAIN = "zamba2-7b-instruct.train-4x2048"
SMALL = dict(d_model=32, num_heads=4, num_kv_heads=4, head_dim=16,
             shared_attn_heads=4, shared_attn_kv_heads=4, d_ff=48,
             vocab_size=128, ssm_state=8, ssm_head_dim=8, ssd_chunk=8,
             shared_adapter_rank=4, attn_scale=(16 / 2) ** -0.5)


def run_as(config: str) -> dict:
    return json.loads((ROOT / "portbench" / "configs" /
                       f"{config}.json").read_text())["run_as"]


def stage_run_as() -> dict:
    """Layers 6-18 of the 81 as one training stage: hybrid at stage-local
    0, 5 and 11 (block 0 twice, block 1 once), both blocks, the tied
    embedding, float32 masters."""
    g = run_as("zamba2-7b-instruct")["groups"]
    return dict(run_as("zamba2-7b-instruct"), param_dtype="float32",
                groups=[{"layers": g[0]["layers"][-1:], "repeat": 1},
                        dict(g[1], repeat=1), dict(g[2], repeat=1),
                        dict(g[3], repeat=1)])


# ------------------------------------------------ against transformers
def hf_layout(n_layers=10, hybrid=(1, 3, 5, 8)):
    return ["hybrid" if i in hybrid else "mamba" for i in range(n_layers)]


def tiny_hf(types):
    transformers = pytest.importorskip("transformers")
    cfg = transformers.Zamba2Config(
        vocab_size=128, hidden_size=32, num_hidden_layers=len(types),
        layers_block_type=types, mamba_d_state=8, mamba_d_conv=4,
        mamba_expand=2, mamba_ngroups=2, n_mamba_heads=8, chunk_size=32,
        intermediate_size=48, num_attention_heads=4, num_key_value_heads=4,
        num_mem_blocks=2, adapter_rank=4, use_mem_rope=True,
        use_shared_attention_adapter=False, rope_theta=10000,
        rms_norm_eps=1e-5, pad_token_id=None, tie_word_embeddings=True)
    cfg._attn_implementation = "eager"
    torch.manual_seed(0)
    model = transformers.Zamba2ForCausalLM(cfg).float().eval()
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            r = torch.randn(p.shape, generator=gen)
            if name.endswith(("norm.weight", "layernorm.weight")):
                p.copy_(1 + 0.2 * r)              # every norm away from 1
            elif name.endswith(("A_log", "dt_bias")):
                p.copy_(0.3 * r)
            elif name.endswith(".D"):
                p.copy_(1 + 0.2 * r)
            elif "conv1d" in name or "embed" in name:
                p.copy_(0.5 * r)
            else:
                p.copy_(r / math.sqrt(p.shape[-1]))
    return cfg, model


def port_tree(cfg, model, m):
    """The HF model's weights in the port's tree (the benchmark's
    layout): the fused in-projection and convolution split into their
    parts, norms as offsets from 1, linears as (in, out)."""
    d, di = cfg.hidden_size, cfg.mamba_expand * cfg.hidden_size
    gn = cfg.mamba_ngroups * cfg.mamba_d_state
    F = cfg.intermediate_size
    H, hd = cfg.num_attention_heads, cfg.attention_head_dim

    def mamba_leaves(layer):
        mx = layer.mamba
        w, cw, cb = mx.in_proj.weight, mx.conv1d.weight[:, 0], mx.conv1d.bias
        cuts = {"wz": (0, di), "wx": (di, 2 * di), "wB": (2 * di, 2 * di + gn),
                "wC": (2 * di + gn, 2 * di + 2 * gn)}
        ssd = {k: w[a:b].T for k, (a, b) in cuts.items()}
        ssd["wdt"] = w[2 * di + 2 * gn:].T
        for name, (a, b) in (("x", (0, di)), ("B", (di, di + gn)),
                             ("C", (di + gn, di + 2 * gn))):
            ssd[f"conv_{name}"] = cw[a:b].T
            ssd[f"conv_{name}_bias"] = cb[a:b][None]
        ssd.update(A_log=mx.A_log, D=mx.D, dt_bias=mx.dt_bias,
                   gate_norm=mx.norm.weight - 1, wo=mx.out_proj.weight.T)
        return {"ln_mixer": layer.input_layernorm.weight - 1, "ssd": ssd}

    layers, app = [], 0
    for i, kind in enumerate(cfg.layers_block_type):
        lay = model.model.layers[i]
        if kind == "mamba":
            layers.append(mamba_leaves(lay))
            continue
        leaves = mamba_leaves(lay.mamba_decoder)
        ad = lay.shared_transformer.feed_forward.gate_up_proj_adapter_list[app]
        leaves["shared_lin"] = lay.linear.weight.T
        leaves["adapter"] = {"a": ad[0].weight.T, "gate": ad[1].weight[:F].T,
                             "up": ad[1].weight[F:].T}
        layers.append(leaves)
        app += 1
    blocks = []
    for blk in model.model.layers[cfg.hybrid_layer_ids[0]], \
            model.model.layers[cfg.hybrid_layer_ids[1]]:
        b = blk.shared_transformer
        at, ff = b.self_attn, b.feed_forward
        blocks.append({
            "ln": b.input_layernorm.weight - 1,
            "attn": {"wq": at.q_proj.weight.T.reshape(2 * d, H, hd),
                     "wk": at.k_proj.weight.T.reshape(2 * d, H, hd),
                     "wv": at.v_proj.weight.T.reshape(2 * d, H, hd),
                     "wo": at.o_proj.weight.T.reshape(H, hd, d)},
            "ln_mlp": b.pre_ff_layernorm.weight - 1,
            "mlp": {"wi_gate": ff.gate_up_proj.weight[:F].T,
                    "wi_up": ff.gate_up_proj.weight[F:].T,
                    "wo": ff.down_proj.weight.T}})
    assert blocks[0]["ln"].data_ptr() != blocks[1]["ln"].data_ptr()

    def stack(trees):
        if isinstance(trees[0], dict):
            return {k: stack([t[k] for t in trees]) for k in trees[0]}
        return torch.stack([t.detach().float() for t in trees])
    decoder = {}
    for at in check.places(m):
        g = decoder.setdefault(f"g{at.group}", {})
        g.setdefault(f"L{at.position}", []).append(layers[at.index])
    decoder = {g: {p: stack(ls) for p, ls in v.items()}
               for g, v in decoder.items()}
    emb = model.model.embed_tokens.weight.detach()
    assert model.lm_head.weight.data_ptr() == emb.data_ptr()   # tied
    return {"embed": {"embedding": emb,
                      "final_norm": model.model.final_layernorm.weight
                      .detach() - 1},
            "decoder": decoder, "shared_attn": stack(blocks)}


def hf_run_as(cfg) -> dict:
    """``run_as`` of the HF model's shape: its layers as port groups."""
    groups, run = [], []
    for kind in cfg.layers_block_type:
        run.append({"mixer": "ssd", "mlp": "none",
                    "shared_attn": kind == "hybrid"})
        if kind == "hybrid":
            groups.append({"layers": run, "repeat": 1})
            run = []
    groups += [{"layers": [ls], "repeat": 1} for ls in run]
    return {"d_model": cfg.hidden_size, "vocab_size": cfg.vocab_size,
            "head_dim": cfg.attention_head_dim, "rope_theta": 10000.0,
            "ssm_state": cfg.mamba_d_state, "ssm_expand": cfg.mamba_expand,
            "ssm_head_dim": cfg.mamba_headdim,
            "ssm_ngroups": cfg.mamba_ngroups, "ssm_conv_width": 4,
            "ssd_chunk": cfg.chunk_size,
            "shared_attn_heads": cfg.num_attention_heads,
            "shared_attn_kv_heads": cfg.num_key_value_heads,
            "shared_blocks": 2, "shared_adapter_rank": cfg.adapter_rank,
            "d_ff": cfg.intermediate_size, "norm_eps": cfg.rms_norm_eps,
            "tie_embeddings": True, "groups": groups}


def rel(a, b) -> float:
    return check.rel_l2(a, b)


@pytest.mark.parametrize("types", [hf_layout(),
                                   ["hybrid", "mamba", "hybrid", "hybrid"]],
                         ids=["ten_layers", "hybrid_first"])
def test_the_reference_is_the_published_forward(types):
    """Every layer's output and the logits of every position, both in
    float32, within 1e-4 of transformers' eager forward (the torch
    fallback of the Mamba2 mixer), from the same weights.  The sequence
    lies in one chunk of the scan: transformers 4.57.6's fallback sums
    the states carried between chunks over the later chunk instead of
    the earlier (``.sum(dim=2)`` of its ``decay_chunk`` product), so
    past one chunk it is not the published model; the reference at a
    chunk of 8 (three chunks) is held to its own one-chunk scan."""
    cfg, model = tiny_hf(types)
    m = hf_run_as(cfg)
    params = port_tree(cfg, model, m)
    tokens = torch.randint(0, cfg.vocab_size, (2, 21),
                           generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        out = model(input_ids=tokens, use_cache=False,
                    output_hidden_states=True)
        x0 = ref.embed(params, tokens)
        x = x0
        for at in check.places(m):
            assert rel(x, out.hidden_states[at.index]) < 1e-4, at.index
            x, _ = ref.layer(at, params, x, x0, m, "f32")
        logits = torch.stack([ref.logits(params, x[:, t], m, "f32")
                              for t in range(tokens.shape[1])], 1)
    assert rel(logits, out.logits) < 1e-4
    with torch.no_grad():
        m8, x8 = dict(m, ssd_chunk=8), x0
        for at in check.places(m8):
            x8, _ = ref.layer(at, params, x8, x0, m8, "f32")
    assert rel(x8, x) < 1e-5
    # the published scale and the groups matter: without them it is off
    with torch.no_grad():
        h, _, _ = ref.shared_block(ref.pick(params["shared_attn"], 0),
                                   ref.layer_leaves(params, next(
                                       a for a in check.places(m)
                                       if a.spec["shared_attn"])),
                                   x0, x0, dict(m, head_dim=m["head_dim"] * 2),
                                   "f32")
        want, _, _ = ref.shared_block(ref.pick(params["shared_attn"], 0),
                                      ref.layer_leaves(params, next(
                                          a for a in check.places(m)
                                          if a.spec["shared_attn"])),
                                      x0, x0, m, "f32")
    assert rel(h, want) > 1e-3


# ------------------------------------------------ counts
def test_counts_at_the_published_widths():
    """By hand, from the published config: a Mamba2 layer 3,584 (norm) +
    3,584 x 14,704 (z 7,168, x 7,168, B and C 2 x 128, dt 112) + 5 x
    7,424 (4 conv taps and the bias) + 3 x 112 + 7,168 (gated norm) +
    7,168 x 3,584 = 78,437,456; a block 7,168 + 7,168 x 21,504 (q, k, v)
    + 7,168 x 3,584 (o) + 3,584 + 3 x 3,584 x 14,336 = 333,982,208; an
    application's adapter and linear 3,584 x 128 + 128 x 28,672 + 3,584^2
    = 16,973,824; the tied embedding 32,000 x 3,584; the final norm."""
    mamba, block, app = 78_437_456, 333_982_208, 16_973_824
    emb = 32_000 * 3_584
    m = run_as("zamba2-7b-instruct")
    assert ref.mamba_params(m) == mamba
    assert ref.block_params(m) == block
    assert ref.application_params(m) == app
    assert ref.param_count(m) == emb + 3_584 + 81 * mamba + 2 * block \
        + 13 * app == 7_356_749_648
    per_token = 81 * mamba + 13 * (block + app) + emb + 3_584
    attn = 4.0 * 4 * (2048 ** 2 / 2) * 32 * 224 * 13
    assert ref.model_flops(m, 4, 2048, "prefill") == \
        2.0 * per_token * 4 * 2048 + attn
    assert 183e12 < ref.model_flops(m, 4, 2048, "prefill") < 185e12
    s = stage_run_as()
    assert ref.param_count(s) == emb + 3_584 + 13 * mamba + 2 * block \
        + 3 * app
    stage = 13 * mamba + 3 * (block + app) + emb + 3_584
    assert ref.model_flops(s, 4, 2048, "train") == \
        6.0 * stage * 4 * 2048 + 3 * 4.0 * 4 * (2048 ** 2 / 2) * 32 * 224 * 3


def test_the_program_counts_the_same_parameters():
    cfg = harness.program_config({"run_as": run_as("zamba2-7b-instruct")},
                                 "cpu")
    assert cfg.param_count() == ref.param_count(run_as("zamba2-7b-instruct"))
    s = stage_run_as()
    assert harness.program_config({"run_as": s}, "cpu").param_count() == \
        ref.param_count(s)


# ------------------------------------------------ readers
def op(name, dur_ms, *ancestors):
    return tr.DeviceOp(name, math.nan, dur_ms / 1e3, tuple(ancestors))


def a_run(cell, ops, steps=2):
    man = harness.manifest(ROOT)
    entry = harness.cell_entry(man, cell)
    conf = harness.config_file(man, entry["config"])
    traffic = harness.load_json(ROOT / "portbench" / "traffic" /
                                f"{entry['traffic']}.json")
    trace = tr.Trace(ops, 1.0, 0.5, [], ops)
    return harness.Run(conf, ref, traffic, 0.5, steps, trace)


def test_each_new_reader_on_a_trace_made_by_hand():
    ops = [op("gemm", 3.0, "aten::mm", "attention_block", "shared_block",
              "serve.prefill"),
           op("gelu", 1.0, "aten::gelu", "shared_block", "serve.prefill"),
           op("ssd_scan_wgmma_kernel", 0.5, "repro_torch::ssd_scan",
              "ssd_block", "serve.prefill"),
           op("ssd_scan_wgmma_kernel", 1.5, "repro_torch::ssd_scan",
              "ssd_block", "serve.prefill"),
           op("gemm", 2.0, "aten::mm", "ssd_block", "serve.prefill"),
           op("other", 7.0, "aten::add")]
    run = a_run(PREFILL, ops)
    read = {n: harness.load_metric(n).read(run) for n in
            ("shared_block_ms.prefill", "ssd_block_ms.prefill",
             "ssd_scan_roofline",
             "shared_attention_ms.prefill", "flash_fwd_roofline")}
    assert read["shared_block_ms.prefill"] == pytest.approx(2.0)
    assert read["ssd_block_ms.prefill"] == pytest.approx(2.0)
    assert read["shared_attention_ms.prefill"] == pytest.approx(1.5)
    assert read["flash_fwd_roofline"] is None     # no flash kernel
    # the scan at B=4 S=2048 H=112 P=N=64 G=2, chunk 256, over 1 ms
    from portbench.counts import flops
    bound = flops.roofline_ms(flops.ssd_ops(4, 2048, 112, 64, 64, 256),
                              flops.ssd_bytes(4, 2048, 112, 64, 2, 64))
    assert read["ssd_scan_roofline"] == pytest.approx(100.0 * bound)
    # a trace without the spans or the kernel reads nothing
    bare = a_run(PREFILL, [op("other", 7.0, "aten::add")])
    for name in ("shared_block_ms.prefill", "ssd_block_ms.prefill",
                 "ssd_scan_roofline"):
        assert harness.load_metric(name).read(bare) is None


def test_flash_roofline_reads_the_shared_blocks_shape():
    run = a_run(PREFILL, [op("flash_fwd_mma_kernel", 1.0, "x")])
    from portbench.counts import flops
    bound = flops.roofline_ms(flops.flash_flops(4, 2048, 2048, 32, 224, True),
                              flops.flash_bytes(4, 2048, 32, 32, 224))
    assert harness.load_metric("flash_fwd_roofline").read(run) == \
        pytest.approx(100.0 * bound)


# ------------------------------------------------ the cells, small
@pytest.fixture
def small(monkeypatch):
    monkeypatch.setitem(portbench_small.SMALL, "zamba2-7b-instruct",
                        dict(SMALL, repeats=(1, 1, 2, 1)))


@pytest.fixture(autouse=True)
def empty_totals():
    from repro_torch import spans
    spans.clear()
    yield
    spans.clear()


def applications(tree, cell) -> int:
    man = harness.manifest(tree)
    conf = harness.config_file(man, harness.cell_entry(man, cell)["config"],
                               tree / "portbench")
    return sum(bool(at.spec["shared_attn"])
               for at in check.places(conf["run_as"]))


def train_tree(dest):
    """A small copy of the benchmark with a training cell of the stage
    above added beside the prefill cell: its configuration, the accepted
    training traffic cut small, the small training limits, and the cell
    in the lists of the accepted training metrics."""
    tree = small_tree(dest, "zamba2-7b-instruct")
    bench, man = tree / "portbench", harness.manifest(tree)
    full = json.loads((ROOT / "portbench" / "configs" /
                       "zamba2-7b-instruct.json").read_text())
    m = dict(stage_run_as(), **SMALL, dtype=portbench_small.TRAIN_SMALL[
        "dtype"])
    m["groups"] = [dict(g, repeat=r)
                   for g, r in zip(m["groups"], (1, 1, 2, 1))]
    (bench / "configs" / "stage.json").write_text(
        json.dumps(dict(full, run_as=m)))
    man["configs"].append(dict(man["configs"][-1], name="stage",
                               file="portbench/configs/stage.json"))
    man["workloads"].append({"name": TRAIN, "config": "stage",
                             "traffic": "train_2x2048", "chips": 1})
    for metric in man["end_to_end"] + man["per_layer"]:
        if "qwen3-moe-30b-a3b.train-2x2048" in metric.get("workloads", []):
            metric["workloads"].append(TRAIN)
    lim = dict(portbench_small.TRAIN_SMALL["limits"])
    del lim["route_err"]
    (bench / "limits" / f"{TRAIN}.json").write_text(json.dumps(lim))
    tp = bench / "traffic" / "train_2x2048.json"
    tp.write_text(json.dumps(dict(json.loads(tp.read_text()), batch=2,
                                  seq=32, pool=4, profile_steps=1)))
    (tree / "BENCHMARK.json").write_text(json.dumps(man))
    return tree


def test_the_prefill_cell_runs_small_and_is_judged(tmp_path, small):
    from repro_torch import spans
    tree = small_tree(tmp_path, "zamba2-7b-instruct")
    out = run_small(tree, PREFILL, trace=True)
    assert out["correct"], out["checks"]
    assert {"state_err", "conv_err", "kv_err", "layer_err",
            "logits_err"} <= set(out["checks"])
    assert out["checks"]["kv_err"]["value"] > 0
    # one span an application and an SSD layer a batch: the groups'
    # hybrid layers at repeats 1, 1, 2
    assert spans.COUNTS["shared_block"] == applications(tree, PREFILL) == 4
    assert spans.COUNTS["ssd_block"] == 7 + 5 + 12 + 1
    assert out["metrics"]["mfu.prefill"]["value"] > 0


def test_the_train_cell_runs_small_and_is_judged(tmp_path, small):
    from repro_torch import spans
    tree = train_tree(tmp_path)
    out = run_small(tree, TRAIN, trace=True)
    assert out["correct"], out["checks"]
    # the profiled step: each application in the forward and the recompute
    assert spans.COUNTS["shared_block"] == 2 * applications(tree, TRAIN) == 8
    assert out["metrics"]["mfu.train"]["value"] > 0


def test_a_fault_fails_the_small_prefill(tmp_path, small):
    from portbench.loops import prefill
    tree = small_tree(tmp_path, "zamba2-7b-instruct")
    with prefill.half_batch():
        out = run_small(tree, PREFILL)
    assert not out["correct"]


# ------------------------------------------------ imports
def test_the_reference_imports_no_program_module():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import portbench.reference.zamba2\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('repro', 'repro_torch', 'jax'))\n"
            "print(bad); assert not bad\n" % str(ROOT))
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT)


def test_the_parent_program_refuses_the_new_configuration():
    """A program without the configuration fails at set-up, by name."""
    conf = {"run_as": dict(run_as("zamba2-7b-instruct"),
                           registered="no-such-arch")}
    with pytest.raises(KeyError):
        harness.program_config(conf, "cpu")


def test_both_files_list_the_published_keys():
    cat = dict(hybrid_layer_ids=[6, 11] + list(range(17, 78, 6)),
               num_hidden_layers=81, num_mem_blocks=2, mamba_ngroups=2,
               attention_head_dim=224, adapter_rank=128, use_conv_bias=True)
    full = json.loads((ROOT / "portbench" / "configs" /
                       "zamba2-7b-instruct.json").read_text())
    for k, v in cat.items():
        assert full[k] == v, k
    assert full["reduced"] == [] and full["reference"] == "zamba2"
    hyb = [at.index for at in check.places(full["run_as"])
           if at.spec["shared_attn"]]
    assert hyb == full["hybrid_layer_ids"]
    # the tests' training stage: layers 6-18 of the published order
    stage = ["hybrid" if at.spec["shared_attn"] else "mamba"
             for at in check.places(stage_run_as())]
    assert stage == full["layers_block_type"][6:19]


def test_the_new_cells_join_the_accepted_metrics():
    man = harness.manifest(ROOT)
    prefill = {m["name"] for m in harness.cell_metrics(man, PREFILL, True)}
    assert prefill == {"mfu.prefill", "idle_share.prefill",
                       "launches.prefill", "flash_fwd_roofline",
                       "shared_block_ms.prefill", "ssd_block_ms.prefill",
                       "ssd_scan_roofline", "shared_attention_ms.prefill"}
    assert {m["name"] for m in harness.cell_metrics(man, PREFILL, False)} \
        == {"prefill_tokens_per_s", "prefill_ms_p95", "setup_s"}


def test_a_fault_that_halves_the_batch_is_judged_not_raised(tmp_path, small):
    """The train loop's half_batch fault runs each layer on the batch's
    first rows: the reference takes the same rows of x0, and the change
    of the parameters tells the fault."""
    from portbench.loops import train
    tree = train_tree(tmp_path)
    with train.half_batch():
        out = run_small(tree, TRAIN)
    assert not out["correct"]
    assert out["checks"]["update_err"]["value"] > \
        out["checks"]["update_err"]["limit"]
