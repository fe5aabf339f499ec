"""The port's tools: the model's spec helpers, the energy model, the cost
counter (``launch/cost.py``), the one-card dry run (``launch/dryrun.py``)
and the examples.

* ``param_count``, ``active_param_count``, ``cell_supported``,
  ``train_specs`` and ``decode_specs`` equal the JAX package's (on
  ``jax.eval_shape``) for every config at full width -- shapes only, no
  weight drawn in either package; the dry run's model-FLOPs formula equals
  the JAX dry run's on every cell (``repro.launch.dryrun`` runs in a
  subprocess: at import it asks XLA for 512 host devices);
  ``hw/energy.py`` equals the JAX package's exactly.
* On ``meta`` tensors with ``backend="cuda"`` the kernel wrappers' launches
  equal the counts ``chip_smoke.py`` holds the card's runs to
  (``train_launch_counts``, ``family_launch_counts``), family by family.
* With ``backend="torch"``, a meta trace and a real CPU run of the same
  cell count the same FLOPs, bytes and peak live bytes.
"""
import json
import math
import os
import pathlib
import subprocess
import sys

import jax
import pytest
import torch

import chip_smoke as CS
from repro.configs.base import SHAPES as JAX_SHAPES
from repro.configs.base import get_config as jax_config
from repro.configs.base import list_configs
from repro.hw import energy as JE
from repro.models import model as JM
from repro_torch.configs.base import SHAPES, ShapeConfig, get_config
from repro_torch.core.policy import MXSF_INFER, MXSF_TRAIN
from repro_torch.hw import energy as TE
from repro_torch.launch import cost, dryrun
from repro_torch.models import blocks
from repro_torch.models import model as M
from repro_torch.optim.adamw import OptConfig
from repro_torch.train import step as T

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCHS = list_configs()


def _small(arch):
    """The reduced config at the fewest layers that keep its structure
    (the hybrid: one group of SSD layers with the shared block, and a
    tail)."""
    cfg = get_config(arch).reduced()
    return cfg.replace(n_layers=4 if cfg.family == "hybrid" else 2)


def _jax_params(arch):
    return jax.eval_shape(lambda: JM.init_params(jax.random.PRNGKey(0),
                                                 jax_config(arch)))


def _meta_params(arch):
    return M.init_params(get_config(arch), torch.Generator(), "meta")


def _shapes(tree, prefix=()):
    """{path: (shape, dtype name)} of a tree of arrays or tensors."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_shapes(v, prefix + (k,)))
        return out
    return {prefix: (tuple(tree.shape), str(tree.dtype).split(".")[-1])}


@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_match_jax(arch):
    spec, meta = _jax_params(arch), _meta_params(arch)
    assert M.param_count(meta) == JM.param_count(spec)
    assert (M.active_param_count(get_config(arch), meta)
            == JM.active_param_count(jax_config(arch), spec))


@pytest.mark.parametrize("arch", ARCHS)
def test_cell_specs_match_jax(arch):
    """cell_supported, train_specs and decode_specs (both cache formats,
    ring or not) on every shape; a family the JAX package gives no decode
    cache raises in both."""
    cj, ct = jax_config(arch), get_config(arch)
    for name, shape in SHAPES.items():
        js = JAX_SHAPES[name]
        assert M.cell_supported(ct, shape) == JM.cell_supported(cj, js)
        assert (_shapes(M.train_specs(ct, shape))
                == _shapes(JM.train_specs(cj, js)))
        for kv_fmt in ("", "mxsf"):
            for ring in (True, False):
                try:
                    want = _shapes(JM.decode_specs(cj, js, ring, kv_fmt))
                except ValueError:
                    with pytest.raises(ValueError):
                        M.decode_specs(ct, shape, ring, kv_fmt)
                    continue
                got = M.decode_specs(ct, shape, ring, kv_fmt)
                assert all(t.is_meta for t in cost._leaf_tensors(got))
                assert _shapes(got) == want, (name, kv_fmt, ring)


def test_model_flops_match_the_jax_dry_run():
    code = """
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=1"
os.environ["JAX_PLATFORMS"] = "cpu"
sys.path.insert(0, %r)
import jax
from repro.configs.base import SHAPES, get_config, list_configs
from repro.launch import dryrun as D
from repro.models import model as M
out = {}
for a in list_configs():
    cfg = get_config(a)
    spec = jax.eval_shape(lambda: M.init_params(jax.random.PRNGKey(0), cfg))
    for s, shape in SHAPES.items():
        out[a + "/" + s] = D._analytic_model_flops(cfg, shape, spec)
print(json.dumps(out))
""" % str(ROOT / "src")
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=1")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300, cwd=str(ROOT))
    assert res.returncode == 0, res.stderr[-2000:]
    want = json.loads(res.stdout.strip().splitlines()[-1])
    for arch in ARCHS:
        params = _meta_params(arch)
        for s, shape in SHAPES.items():
            got = dryrun._analytic_model_flops(get_config(arch), shape,
                                               params)
            assert list(got) == want[f"{arch}/{s}"], (arch, s)


def test_energy_matches_jax_exactly():
    for batch, seq in ((64, 197), (8, 65), (1, 1)):
        cj = JE.training_step_counts(jax_config("deit-tiny"), batch, seq)
        ct = TE.training_step_counts(get_config("deit-tiny"), batch, seq)
        assert ct.__dict__ == cj.__dict__
        for fmt in JE.MAC_PJ:
            for blk in (8, 16, 32, 64, 128):
                assert TE.block_bits(fmt, blk) == JE.block_bits(fmt, blk)
                for bf16_attn in (False, True):
                    assert (TE.step_energy(ct, fmt, blk, bf16_attn)
                            == JE.step_energy(cj, fmt, blk, bf16_attn))
    assert TE.DRAM_PJ_PER_BIT == JE.DRAM_PJ_PER_BIT
    assert TE.SRAM_PJ_PER_BIT == JE.SRAM_PJ_PER_BIT
    assert TE.BITS_PER_ELEM == JE.BITS_PER_ELEM


def test_make_serve_step_is_decode_step_bitwise():
    cfg = get_config("qwen2.5-32b-reduced")
    pol = MXSF_INFER.replace(kv_cache_fmt="mxsf", backend="cuda")
    params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tokens = torch.randint(0, cfg.vocab, (2, 1),
                           generator=torch.Generator().manual_seed(1),
                           dtype=torch.int32)
    pos = torch.tensor([3, 7], dtype=torch.int32)
    outs = []
    for fn in (T.make_serve_step(cfg, pol),
               lambda *a: M.decode_step(*a, cfg, pol)):
        cache = M.init_cache(cfg, 2, 16, kv_fmt="mxsf", device="cpu")
        outs.append(fn(params, tokens, cache, pos))
    assert torch.equal(outs[0][0], outs[1][0])
    for k in outs[0][1]:
        assert torch.equal(outs[0][1][k], outs[1][1][k])


# ---------------------------------------------------------------------------
# the counter on meta tensors
# ---------------------------------------------------------------------------

P2 = MXSF_TRAIN.replace(backend="cuda")
P1 = P2.replace(block_mode="1d", quantize_bwd=True)


@pytest.mark.parametrize("arch,policy,remat", [
    ("h2o-danube-1.8b", P2, "dots"), ("h2o-danube-1.8b", P1, "dots"),
    ("h2o-danube-1.8b", P2, "none"), ("h2o-danube-1.8b", P2, "full"),
    ("qwen2-moe-a2.7b", P2, "dots"), ("mamba2-780m", P2, "dots"),
    ("zamba2-7b", P2, "dots"), ("whisper-medium", P2, "dots"),
    ("internvl2-1b", P2, "dots")],
    ids=lambda v: v if isinstance(v, str) else v.block_mode)
def test_traced_training_launches_equal_the_paths_counts(arch, policy,
                                                         remat):
    cfg = _small(arch)
    shape = ShapeConfig("t", 16, 2, "train")
    tcfg, ocfg = T.TrainConfig(remat=remat), OptConfig()
    inputs = dryrun.cell_inputs(cfg, shape, policy, ocfg)
    with cost.count(inputs) as c:
        dryrun.cell_program(cfg, shape, policy, tcfg, ocfg)(inputs)
    want = CS.train_launch_counts(cfg, policy, remat)
    assert dict(c.launches) == {k: v for k, v in want.items() if v}


@pytest.mark.parametrize("arch", ["qwen2.5-32b", "h2o-danube-1.8b",
                                  "gemma2-2b", "qwen2-moe-a2.7b",
                                  "mamba2-780m", "zamba2-7b",
                                  "whisper-medium", "internvl2-1b"])
def test_traced_serving_launches_equal_the_paths_counts(arch):
    """A decode step and a prefill over the packed store and the packed
    cache, on meta: the launches of ``family_launch_counts``."""
    cfg = _small(arch)
    pol = MXSF_INFER.replace(kv_cache_fmt="mxsf", backend="cuda")
    params = M.packed_model_specs(cfg, pol)
    B = 2
    for kind in ("decode", "prefill"):
        cache = M.init_cache(cfg, B, 32, kv_fmt="mxsf", device="meta")
        with cost.count((params, cache)) as c:
            if kind == "decode":
                dspec = M.decode_specs(cfg, ShapeConfig("d", 32, B, kind),
                                       kv_fmt="mxsf")
                M.decode_step(params, dspec["tokens"], cache, dspec["pos"],
                              cfg, pol)
            else:
                batch = M.train_specs(cfg, ShapeConfig("p", 16, B, kind))
                M.prefill(params, batch, cache, cfg, pol)
        want = CS.family_launch_counts(cfg, M.decode_attn_backend(cfg, pol),
                                       kind)
        assert dict(c.launches) == {k: v for k, v in want.items() if v}, kind


@pytest.mark.parametrize("arch,kind", [
    ("h2o-danube-1.8b", "train"), ("qwen2-moe-a2.7b", "prefill"),
    ("mamba2-780m", "decode"), ("zamba2-7b", "prefill"),
    ("whisper-medium", "decode"), ("internvl2-1b", "prefill")])
def test_meta_trace_counts_what_a_cpu_run_runs(arch, kind):
    cfg = _small(arch)
    shape = ShapeConfig("t", 32, 4, kind)
    pol = dryrun.cell_policy("mxsf", kind, kv_cache="mxsf")
    tcfg, ocfg = T.TrainConfig(), OptConfig()
    run = dryrun.cell_program(cfg, shape, pol, tcfg, ocfg)
    got = []
    for device in ("meta", "cpu"):
        inputs = dryrun.cell_inputs(cfg, shape, pol, ocfg, device=device,
                                    generator=torch.Generator().manual_seed(0))
        with cost.count(inputs) as c:
            out = run(inputs)
        got.append(c.summary(out))
        del inputs, out
    assert got[0] == got[1]
    s = got[0]
    assert s["memory"]["peak_bytes_per_device"] > \
        s["memory"]["argument_bytes"] > 0
    assert s["cost"]["flops_per_device"] > 0 and \
        s["cost"]["hbm_bytes_per_device"] > 0


def test_counter_reckons_ops_bytes_and_live_storage():
    a = torch.ones((64, 32), dtype=torch.bfloat16)
    b = torch.ones((32, 16), dtype=torch.bfloat16)
    idx = torch.tensor([1, 5])
    with cost.count((a, b)) as c:
        y = a @ b                       # 2 m k n at the bf16 rate
        z = torch.exp(y.float())        # 1 an element (the cast: none)
        s = z.sum()                     # 1 an input element
        r = a[idx]                      # a gather: 2 rows, not the table
        v = a.t()                       # a view: nothing
        del z
    out = c.summary((y, s, r, v))
    assert c.flops_bf16 == 2 * 64 * 32 * 16
    assert c.flops_f32 == 64 * 16 + 64 * 16
    mm = 64 * 32 * 2 + 32 * 16 * 2 + 64 * 16 * 2
    cvt = 64 * 16 * 2 + 64 * 16 * 4
    gather = idx.numel() * 8 + 2 * 2 * 32 * 2
    assert c.aten_bytes == mm + cvt + 2 * 64 * 16 * 4 + 64 * 16 * 4 + 4 \
        + gather
    mem = out["memory"]
    assert mem["argument_bytes"] == a.nbytes + b.nbytes
    assert mem["output_bytes"] == y.nbytes + s.nbytes + r.nbytes
    # live at once at most: arguments, y, y.float(), exp's result
    assert mem["peak_bytes_per_device"] == (a.nbytes + b.nbytes + y.nbytes
                                            + 2 * 64 * 16 * 4)


def test_kernel_launch_records_its_work_and_scratch():
    """A wrapper's meta branch records one launch with its reckoning (the
    card run's bound uses the same function) and no aten op."""
    from repro_torch.kernels import mxsf_fused_matmul as FM
    from repro_torch.kernels import mxsf_quant as MQ
    x = torch.empty((128, 512), dtype=torch.bfloat16, device="meta")
    w = torch.empty((512, 1024), dtype=torch.float32, device="meta")
    with cost.count((x, w)) as c:
        wc, ws = MQ.mxsf_quantize(w, (64, 1))
        y = FM.mxsf_fused_matmul(x, wc, ws)
    assert y.is_meta and tuple(y.shape) == (128, 1024)
    assert (tuple(wc.shape), tuple(ws.shape)) == ((512, 1024), (8, 1024))
    assert dict(c.launches) == {"mxsf_quantize": 1, "mxsf_fused_matmul": 1}
    want = (cost.quantize_work(512, 1024, (64, 1), 4).nbytes
            + cost.fused_matmul_work(128, 512, 512, 1024, 2).nbytes)
    assert c.launch_bytes == want and c.aten_bytes == 0
    assert c.flops_bf16 == 2 * 128 * 512 * 1024
    assert FM.launches == 0 and MQ.launches["mxsf_quantize"] == 0


def test_attention_meta_visible_counts_the_causal_pairs():
    from repro_torch.kernels import mxsf_attention as MA
    assert MA.meta_visible(1, 100, True, None, None, None) == (100, 100)
    assert MA.meta_visible(4, 4, True, None, 0, None) == (4, 10)
    assert MA.meta_visible(2, 10, True, 6, None, None) == (6, 11)
    assert MA.meta_visible(1, 100, True, None, None, 16) == (100, 16)


def test_chip_smoke_bounds_come_from_the_cost_module():
    """The card run's per-kernel bound and peaks are launch/cost.py's."""
    src = (ROOT / "chip_smoke.py").read_text()
    for literal in ("3.35e12", "989e12", "67e12"):
        assert literal not in src
    for name in ("fused_matmul_work", "mx_matmul_work", "attention_work",
                 "quantize_work", "requantize_work", "bound_ms"):
        assert f"cost.{name}(" in src, name


# ---------------------------------------------------------------------------
# the cache write, the dry run's CLI, the examples
# ---------------------------------------------------------------------------

def _write_cache_by_index(buf, upd, slot, write_len):
    """The write as an index set of the kept rows (a ``nonzero``)."""
    S, W = upd.shape[1], buf.shape[1]
    ar = torch.arange(S)
    cols = slot[:, None] + ar[None, :]
    keep = (ar[None, :] < write_len[:, None]) & (cols < W)
    bi, si = keep.nonzero(as_tuple=True)
    buf[bi, cols[bi, si]] = upd[bi, si]


@pytest.mark.parametrize("dtype", [torch.uint8, torch.bfloat16])
def test_cache_write_equals_the_index_form(dtype):
    """``_write_cache`` with ``write_len`` (fixed-shape, meta-traceable)
    leaves the same bytes as the index-set write, for chunks that fit,
    run past the cache end, are masked (length 0) or wider than the
    cache, and slots far past it."""
    g = torch.Generator().manual_seed(0)
    W = 12
    for S, slots, lens in ((4, [0, 3, 8, 10], [4, 2, 4, 3]),
                           (4, [11, 12, 40, 5], [4, 4, 0, 0]),
                           (16, [0, 2, 7, 0], [16, 9, 3, 12])):
        buf = torch.randint(0, 255, (4, W, 2, 3), generator=g).to(dtype)
        upd = torch.randint(0, 255, (4, S, 2, 3), generator=g).to(dtype)
        slot, wl = torch.tensor(slots), torch.tensor(lens)
        want = buf.clone()
        _write_cache_by_index(want, upd, slot, wl)
        blocks._write_cache(buf, upd, slot, wl)
        assert torch.equal(buf.view(torch.uint8), want.view(torch.uint8))
        meta = torch.empty((4, W, 2, 3), dtype=dtype, device="meta")
        blocks._write_cache(meta, upd.to("meta"), slot.to("meta"),
                            wl.to("meta"))


def test_dryrun_cli_writes_the_record(tmp_path):
    SHAPES["tools_decode"] = ShapeConfig("tools_decode", 64, 2, "decode")
    try:
        dryrun.main(["--arch", "internvl2-1b-reduced", "--shape",
                     "tools_decode", "--backend", "cuda", "--kv-cache",
                     "mxsf", "--out", str(tmp_path)])
    finally:
        del SHAPES["tools_decode"]
    rec = json.loads(
        (tmp_path / "internvl2-1b-reduced__tools_decode__1x1.json")
        .read_text())
    for key in ("memory", "cost", "roofline", "collectives", "mesh",
                "model_flops_global", "useful_flops_fraction",
                "params_total", "params_active", "policy", "fits"):
        assert key in rec, key
    for key in ("argument_bytes", "output_bytes", "temp_bytes",
                "peak_bytes_per_device"):
        assert rec["memory"][key] > 0, key
    assert rec["collectives"] == {} and rec["mesh"] == "1x1"
    assert rec["roofline"]["collective_s"] == 0 and rec["fits"]
    cfg = get_config("internvl2-1b-reduced")
    assert rec["cost"]["launches"] == {
        k: v for k, v in CS.family_launch_counts(cfg, "cuda-packed").items()
        if v} | {"mxsf_quantize": CS.family_launch_counts(
            cfg, "cuda-packed")["mxsf_fused_matmul"]}
    assert rec["policy"]["block_mode"] == "1d"
    assert rec["policy"]["kv_cache"] == "mxsf"
    assert math.isclose(rec["useful_flops_fraction"],
                        rec["model_flops_global"]
                        / rec["cost"]["flops_per_device"])
    with pytest.raises(NotImplementedError, match="The dry run on a mesh"):
        dryrun.main(["--multi-pod", "--out", str(tmp_path)])


@pytest.mark.parametrize("example,args,lines", [
    ("torch_quickstart.py", [], ["codes      :", "grad finite: True",
                                 "packed bytes:"]),
    ("torch_serve_decode.py", ["--requests", "3", "--gen", "4",
                               "--prompt-len", "8"],
     ["weight store:", "generated 12 tokens", "sample:"])])
def test_examples_run_on_the_cpu(example, args, lines):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, str(ROOT / "examples" / example),
                          "--device", "cpu", *args], capture_output=True,
                         text=True, env=env, timeout=300, cwd=str(ROOT))
    assert res.returncode == 0, res.stderr[-2000:]
    for line in lines:
        assert line in res.stdout, (line, res.stdout)
