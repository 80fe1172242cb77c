"""PyTorch port: the multi-pod dry-run (``repro_torch.launch.dryrun``)
against the JAX package's.

The cell rules (``cell_is_skipped``, the skip record) are held to the
reference's for every arch and shape.  ``run_cell`` runs end to end on
reduced configs of the dense, MoE, audio, RWKV6 and hybrid families with
small shapes, on fake worlds of 4 x 4 and 2 x 4 x 4 ranks (started and
destroyed by the cell itself): status ``ok``, the reference record's
keys, and the model FLOPs of the reference's formula.  The reference's
dry-run module forces 512 host devices through ``XLA_FLAGS`` when it is
imported; JAX's backend is started first, so that this process keeps its
one CPU device, and the variable is restored.

Each cell's counts are also held to the reference's own ``lower_cell`` on
the same reduced config, shape and mesh, run in a subprocess on 32 forced
host devices: per-device matmul FLOPs (the ``dot`` ops of its partitioned
HLO), the kinds of collectives and, for train and prefill, the argument
bytes a device.  Three cells take the hill-climb's knobs (``remat="dots"``
with 4 microbatches, ``attn_bf16``, ``rules_override``).  The temporary
bytes are held to a hand count on a sharded step, their extrapolation to
a full-depth run, and ``tag`` to the reference's file name.
"""

import gc
import json
import os
import subprocess
import sys
import weakref
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

jax.devices()                        # start the backend before the import below
_flags = os.environ.get("XLA_FLAGS")
from repro.launch import dryrun as jax_dryrun  # noqa: E402

if _flags is None:
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _flags

from repro.configs import get_config as jax_config  # noqa: E402
from repro.launch import analysis as jax_analysis  # noqa: E402
from repro.models.config import SHAPES as JAX_SHAPES  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.models.config import SHAPES, ShapeConfig  # noqa: E402


@pytest.mark.parametrize("shape_name", list(SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cell_is_skipped_matches_reference(arch, shape_name):
    assert dryrun.cell_is_skipped(get_config(arch), SHAPES[shape_name]) == \
        jax_dryrun.cell_is_skipped(jax_config(arch), JAX_SHAPES[shape_name])


@pytest.mark.parametrize("multi_pod", [False, True])
def test_long_500k_skip_record_matches_reference(tmp_path, multi_pod):
    got = dryrun.run_cell("qwen3-4b", "long_500k", multi_pod=multi_pod,
                          out_dir=str(tmp_path / "port"))
    want = jax_dryrun.run_cell("qwen3-4b", "long_500k", multi_pod=multi_pod,
                               out_dir=str(tmp_path / "ref"))
    assert got == want and got["status"] == "skipped"
    mesh = "2x16x16" if multi_pod else "16x16"
    path = tmp_path / "port" / f"qwen3-4b__long_500k__{mesh}.json"
    assert json.loads(path.read_text()) == want


def test_replace_layers_matches_reference():
    for arch in ("qwen3-4b", "whisper-tiny"):
        got, want = (dryrun.replace_layers(get_config(arch), 2),
                     jax_dryrun.replace_layers(jax_config(arch), 2))
        assert got.n_layers == want.n_layers == 2
        assert (got.encoder is None) == (want.encoder is None)
        if got.encoder is not None:
            assert got.encoder.n_layers == want.encoder.n_layers == 2


def reference_ok_keys() -> set:
    """The keys of an ``ok`` record of the reference's ``run_cell``: its
    meta (``lower_cell``), ``Roofline.as_dict()`` and the memory analysis."""
    roof = jax_analysis.Roofline(arch="a", shape="s", mesh="m", chips=1,
                                 hlo_flops=1.0, hlo_bytes=1.0, wire_bytes=0.0,
                                 model_flops=1.0, bytes_per_device=None,
                                 collectives={})
    return set(roof.as_dict()) | {
        "status", "chips", "lower_s", "compile_s", "model_flops", "model_bytes",
        "param_bytes", "n_params", "n_active_params", "memory_analysis"}


CELLS = [  # (arch, kind, mesh extents, knob): each family at least once
    ("qwen3-4b", "train", (4, 4), None),
    ("qwen3-4b", "train", (2, 4, 4), None),
    ("qwen3-4b", "decode", (4, 4), None),
    ("gemma3-1b", "train", (4, 4), None),
    ("mixtral-8x7b", "prefill", (4, 4), None),
    ("deepseek-v2-lite-16b", "train", (4, 4), None),
    ("command-r-plus-104b", "decode", (4, 4), None),
    ("whisper-tiny", "train", (4, 4), None),
    ("whisper-tiny", "decode", (4, 4), None),
    ("rwkv6-3b", "decode", (4, 4), None),
    ("hymba-1.5b", "prefill", (4, 4), None),
    # the hill-climb's knobs (experiments/hillclimb.py), at batch 16
    ("command-r-plus-104b", "train", (4, 4), "dots_mb4"),
    ("mixtral-8x7b", "train", (4, 4), "attn_bf16"),
    ("deepseek-v2-lite-16b", "train", (4, 4), "no_expert_fsdp"),
]
KNOBS = {None: {},
         "dots_mb4": {"remat": "dots", "microbatches": 4},
         "attn_bf16": {"attn_bf16": True},
         "no_expert_fsdp": {"rules_override": {"expert_fsdp": ()}}}
SEQ, BATCH = 16, 8


def batch_of(knob) -> int:
    return BATCH if knob is None else 16

# The reference's lower_cell on a forced host world, with the tiny shape
# registered and the production mesh replaced by the cell's extents (in
# the subprocess only), printing per-device dot FLOPs read from the
# partitioned HLO and the reference's own collective counts.
_REFERENCE = r"""
import json, math, re, sys
import jax
jax.devices()
from repro.configs import get_config
from repro.launch import dryrun as D, mesh as M
from repro.models.config import ShapeConfig

DEF = re.compile(r"^\s*(?:ROOT\s+)?%([\w.\-]+)\s*=\s*\w+\[([\d,]*)\]")
DOT = re.compile(r"=\s*\w+\[([\d,]*)\]\S*\s+dot\(%([\w.\-]+)")

def dims(text):
    return [int(d) for d in text.split(",") if d]

def dot_flops(hlo):
    shapes = {m.group(1): dims(m.group(2))
              for m in map(DEF.match, hlo.splitlines()) if m}
    total = 0
    for line in hlo.splitlines():
        m = DOT.search(line)
        if m:
            lhs = shapes[m.group(2)]
            k = re.search(r"lhs_contracting_dims=\{([\d,]*)\}", line).group(1)
            total += 2 * math.prod(dims(m.group(1))) * math.prod(lhs[i] for i in dims(k))
    return total, hlo.count(" while(")

out = []
for arch, kind, ext, seq, batch, kw in json.loads(sys.argv[1]):
    axes = ("pod", "data", "model") if len(ext) == 3 else ("data", "model")
    D.make_production_mesh = (lambda *, multi_pod=False, e=tuple(ext), a=axes:
                              jax.make_mesh(e, a, **M._axis_kw(len(a))))
    name = f"tiny_{kind}_{batch}"
    D.SHAPES[name] = ShapeConfig(name, seq, batch, kind)
    if "rules_override" in kw:
        kw["rules_override"] = {k: tuple(v) for k, v in kw["rules_override"].items()}
    compiled, _ = D.lower_cell(arch, name, multi_pod=len(ext) == 3,
                               cfg=get_config(arch, reduced=True), scan_unroll=True,
                               **kw)
    flops, loops = dot_flops(compiled.as_text())
    out.append({"dot_flops": flops, "loops": loops,
                "collectives": D._raw_stats(compiled)[3],
                "arguments": compiled.memory_analysis().argument_size_in_bytes})
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference_cells():
    """{(arch, kind, dims): the reference's per-device dot FLOPs, its
    count of HLO while loops and its collective counts}, all cells in one
    subprocess."""
    src = str(Path(__file__).resolve().parents[1] / "src")
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=32",
           "PYTHONPATH": os.pathsep.join([src, os.environ.get("PYTHONPATH", "")])}
    arg = json.dumps([[a, k, list(d), SEQ, batch_of(knob), KNOBS[knob]]
                      for a, k, d, knob in CELLS])
    run = subprocess.run([sys.executable, "-c", _REFERENCE, arg], env=env,
                         capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-3000:]
    return dict(zip(CELLS, json.loads(run.stdout.strip().splitlines()[-1])))


def attention_exemption(arch: str, kind: str, dims, batch: int = BATCH) -> float:
    """The per-device FLOPs by which the port's count of attention falls
    short of the reference's by design: ``attention_full`` is priced as
    the flash kernel's work, 4 hd a (query, key) pair the causal mask
    leaves, where the reference's einsum multiplies all S^2 pairs.  Once
    for a prefill, twice for a train step (its forward and the forward
    recomputed under ``remat="full"``); decode attends over a cache by
    einsum on both sides, and MLA, RWKV and the encoder-decoder do not
    run ``attention_full``."""
    cfg = jax_config(arch, reduced=True)
    if kind == "decode" or cfg.mla is not None or cfg.family in ("ssm", "audio"):
        return 0.0
    S = SEQ + (cfg.vision.n_patches if cfg.family == "vlm" else 0)
    windows = [w for w in (cfg.sliding_window, getattr(cfg, "local_window", None)) if w]
    assert all(w >= S for w in windows)        # so the mask is causal alone
    model, rows = dims[-1], batch // int(np.prod(dims[:-1]))
    heads = cfg.n_heads // model if cfg.n_heads % model == 0 else cfg.n_heads
    skipped = S * S - S * (S + 1) // 2
    evals = 2 if kind == "train" else 1
    return float(evals * cfg.n_layers * 4 * cfg.hd * rows * heads * skipped)


# cells whose count may differ from the reference's past the attention
# exemption, and why: GSPMD narrows some small products further than
# DTensor's op-by-op layouts do
NARROWER_UNDER_GSPMD = {
    ("mixtral-8x7b", "prefill", (4, 4), None): "the router's contraction split over model",
    ("deepseek-v2-lite-16b", "train", (4, 4), None):
        "the router's contraction split over model",
    ("command-r-plus-104b", "decode", (4, 4), None):
        "6 heads over a model extent of 4: the reference computes the "
        "attention's value product only for the columns its output "
        "projection keeps on each rank",
    ("mixtral-8x7b", "train", (4, 4), "attn_bf16"): "the router's contraction split over model",
    ("deepseek-v2-lite-16b", "train", (4, 4), "no_expert_fsdp"):
        "the router's contraction split over model",
}
BAND = 0.05
# XLA's cost of a while loop is its body's, once: the reference's count of
# a cell with a time scan (hymba's SSM, RWKV6 outside decode) is not the
# step's, so only its collectives are compared
SCANS = {("hymba-1.5b", "prefill", (4, 4), None)}


@pytest.mark.parametrize("arch,kind,dims,knob", CELLS, ids=[
    f"{a}-{k}-dims{i}" + (f"-{knob}" if knob else "")
    for i, (a, k, _, knob) in enumerate(CELLS)])
def test_run_cell_end_to_end(tmp_path, reference_cells, arch, kind, dims, knob):
    shape = ShapeConfig(f"tiny_{kind}", SEQ, batch_of(knob), kind)
    rec = dryrun.run_cell(arch, shape.name, multi_pod=len(dims) == 3,
                          out_dir=str(tmp_path), cfg=get_config(arch, reduced=True),
                          shape=shape, mesh_dims=dims, **KNOBS[knob])
    assert rec["status"] == "ok", rec.get("traceback")
    assert reference_ok_keys() <= set(rec)
    assert rec["mesh"] == "x".join(map(str, dims))
    assert rec["chips"] == int(torch.tensor(dims).prod())
    n = jax_config(arch, reduced=True).n_active_params()
    assert rec["n_active_params"] == n
    tokens = shape.global_batch * (1 if kind == "decode" else shape.seq_len)
    want = (jax_analysis.model_flops_train(n, tokens) if kind == "train"
            else jax_analysis.model_flops_decode(n, tokens))
    assert rec["model_flops"] == want
    assert rec["hlo_flops"] > 0 and rec["hlo_bytes"] > 0
    if rec["chips"] > 1 and kind != "decode":
        assert rec["wire_bytes"] > 0 and rec["collectives"]
    mem = rec["memory_analysis"]
    assert mem["argument_size_in_bytes"] > 0
    assert mem["output_size_in_bytes"] > 0 and mem["temp_size_in_bytes"] > 0
    assert rec["wall_s"] >= 0
    saved = json.loads((tmp_path / f"{arch}__{shape.name}__{rec['mesh']}.json").read_text())
    assert saved["status"] == "ok"

    # against the reference's own lower_cell of the same cell.  XLA's
    # "flops" (elementwise ops too) and "bytes accessed" (a fused kernel's
    # operands once) have no eager counterpart, and the wire bytes follow
    # from the collectives each partitioner picks; compared are the
    # products and the kinds of collectives.
    cell = (arch, kind, dims, knob)
    ref = reference_cells[cell]
    assert (ref["loops"] > 0) == (cell in SCANS)
    if cell not in SCANS:
        want = ref["dot_flops"] - attention_exemption(arch, kind, dims, batch_of(knob))
        if cell in NARROWER_UNDER_GSPMD:
            assert want <= rec["hlo_flops"] <= want * (1 + BAND)
        else:
            assert rec["hlo_flops"] == want
    # the reference's host HLO writes a partial sum's move to a shard as an
    # all-reduce and a slice, and some reshards as collective-permutes or
    # all-to-alls that DTensor writes as gathers: every kind the port
    # issues past reduce-scatter is one the reference issues, and the port
    # gathers and reduces wherever the reference does
    mine, theirs = set(rec["collectives"]), set(ref["collectives"])
    assert mine - {"reduce-scatter"} <= theirs
    assert theirs & {"all-gather", "all-reduce"} <= mine
    # the inputs' layout, the hill-climb's rules included: the same bytes
    # a device as the reference's arguments (a decode cell's caches are
    # the port's own trees and are left out)
    if kind != "decode":
        assert mem["argument_size_in_bytes"] == ref["arguments"]


def test_a_failing_cell_is_recorded_not_swallowed(tmp_path):
    """A cell whose step raises is written as ``status: error`` with its
    traceback; ``main`` without a cell exits non-zero."""
    shape = ShapeConfig("tiny_train", 16, 8, "train")
    rec = dryrun.run_cell("qwen3-4b", shape.name, multi_pod=False,
                          out_dir=str(tmp_path), cfg=get_config("qwen3-4b", reduced=True),
                          shape=shape, mesh_dims=(4, 4), remat="bogus")
    assert rec["status"] == "error" and "bogus" in rec["error"]
    assert "Traceback" in rec["traceback"]
    saved = json.loads((tmp_path / "qwen3-4b__tiny_train__4x4.json").read_text())
    assert saved["status"] == "error"
    with pytest.raises(SystemExit):
        dryrun.main(["--out", str(tmp_path)])


def test_temp_bytes_hand_counted_on_a_sharded_step():
    """The counter's temporary bytes on DTensors over a fake 4 x 4 world:
    a product of a row-sharded (16, 32) and a column-sharded (32, 64)
    float32 tensor, its ReLU and its sum, counted at the local shards
    ((4, 16) float32, 256 bytes each), not at the global (16, 64)."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.launch import analysis, mesh

    with mesh.fake_world(16):
        m = init_device_mesh("cpu", (4, 4), mesh_dim_names=("data", "model"))
        x = distribute_tensor(torch.empty(16, 32, device="meta"), m, [Shard(0), Replicate()])
        w = distribute_tensor(torch.empty(32, 64, device="meta"), m, [Replicate(), Shard(1)])
        with analysis.CostCounter() as c:
            y = torch.relu(x @ w)       # the product (256 B) and y (256 B) at once
            s = y.sum()                 # the product is gone: y and 4 B
        assert tuple(y.to_local().shape) == (4, 16)
        assert c.temp_bytes() == 256 + 256
        assert c.temp_bytes((y, s)) == 256          # the outputs left out
        assert len(c.memory.live) == 2              # y's and s's storages
        # the counter's exit ended the timeline: later deaths free nothing
        # there, and no storage keeps the counter alive
        ref = weakref.ref(c)
        del c
        gc.collect()
        assert ref() is None
        del y, s


PEAK_RTOL = 1e-5

# (arch, knobs): the hill-climb's knobs on the families whose memory comes
# from a full-depth run, and the two whose layers loop over time steps,
# whose memory is extrapolated from depths 1 and 2
MEMORY_CELLS = [
    pytest.param("qwen3-4b", {"remat": "none"}, id="qwen3-4b"),
    pytest.param("deepseek-v2-lite-16b", {"remat": "none"}, id="deepseek-v2-lite-16b"),
    pytest.param("command-r-plus-104b",
                 {"remat": "dots", "microbatches": 4, "attn_bf16": True},
                 id="command-r-plus-104b-bf16_dots_mb4"),
    pytest.param("mixtral-8x7b", {"remat": "dots", "attn_bf16": True},
                 id="mixtral-8x7b-bf16_dots"),
    pytest.param("rwkv6-3b", {"remat": "none"}, id="rwkv6-3b"),
    pytest.param("hymba-1.5b", {"remat": "none"}, id="hymba-1.5b"),
]


@pytest.mark.parametrize("arch,knobs", MEMORY_CELLS)
def test_extrapolated_memory_matches_a_full_depth_run(tmp_path, arch, knobs):
    """A depth-extrapolated record's memory is a 4-layer run's: the
    output and temporary bytes of that run itself, where
    ``memory_depths`` names the full depth; else extrapolated from depths
    1 and 2, the output bytes exactly (a layer adds the same parameters)
    and the temporary bytes within ``PEAK_RTOL`` (a layer adds the same
    saved activations; a few scalar storages, such as the MoE loss's
    running sum, live at the peak or not by a layer's order)."""
    cfg = dryrun.replace_layers(get_config(arch, reduced=True), 4)
    shape = ShapeConfig("tiny_train", 16, 8, "train")
    kw = dict(multi_pod=False, out_dir=str(tmp_path), cfg=cfg, shape=shape,
              mesh_dims=(4, 4), **knobs)
    got = dryrun.run_cell(arch, shape.name, **kw)
    full = dryrun.run_cell(arch, shape.name, roofline=False, **kw)
    two = dryrun.run_cell(arch, shape.name, roofline=False,
                          **{**kw, "cfg": dryrun.replace_layers(cfg, 2)})
    assert got["status"] == full["status"] == two["status"] == "ok"
    assert got["compile_s"] is None and full["compile_s"] is not None
    extrapolated = arch in ("rwkv6-3b", "hymba-1.5b")
    assert got["memory_depths"] == ([1, 2] if extrapolated else [4])
    mem, want = got["memory_analysis"], full["memory_analysis"]
    for k in ("argument_size_in_bytes", "output_size_in_bytes"):
        assert mem[k] == want[k]
    assert abs(mem["temp_size_in_bytes"] - want["temp_size_in_bytes"]) <= \
        (PEAK_RTOL * want["temp_size_in_bytes"] if extrapolated else 0)
    # the two layers more hold more: the delta is not zero
    assert (full["memory_analysis"]["temp_size_in_bytes"]
            > two["memory_analysis"]["temp_size_in_bytes"])


def test_a_peak_that_moves_with_depth_is_read_at_the_full_depth(tmp_path):
    """command-r-plus-104b's ``train_4k`` at full width on 16 x 16 with
    the hill-climb's ``it3`` knobs (bf16 attention, ``remat="dots"``, 4
    microbatches), cut to 4 layers: its peak lies in the embedding's
    backward at depths 1 and 2 and in the saved activations at 4, so
    depths 1 and 2 extrapolated to 4 fall short by more than a tenth,
    and the record holds the 4-layer run's peak to the byte."""
    arch, knobs = "command-r-plus-104b", {"remat": "dots", "microbatches": 4,
                                          "attn_bf16": True}
    cfg = dryrun.replace_layers(get_config(arch), 4)
    kw = dict(multi_pod=False, out_dir=str(tmp_path), cfg=cfg, **knobs)
    got = dryrun.run_cell(arch, "train_4k", **kw)
    full = dryrun.run_cell(arch, "train_4k", roofline=False, **kw)
    assert got["status"] == full["status"] == "ok"
    want = full["memory_analysis"]["temp_size_in_bytes"]
    assert got["memory_analysis"]["temp_size_in_bytes"] == want
    short = [dryrun.run_cell(arch, "train_4k", roofline=False,
                             **{**kw, "cfg": dryrun.replace_layers(cfg, d)})
             ["memory_analysis"]["temp_size_in_bytes"] for d in (1, 2)]
    assert short[1] + 2 * (short[1] - short[0]) < 0.9 * want


def test_tag_suffixes_the_record_file_as_the_reference(tmp_path):
    got = dryrun.run_cell("qwen3-4b", "long_500k", multi_pod=False,
                          out_dir=str(tmp_path / "port"), tag="it1_bf16attn")
    want = jax_dryrun.run_cell("qwen3-4b", "long_500k", multi_pod=False,
                               out_dir=str(tmp_path / "ref"), tag="it1_bf16attn")
    assert got == want
    name = "qwen3-4b__long_500k__16x16__it1_bf16attn.json"
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == [name]
    assert sorted(p.name for p in (tmp_path / "ref").iterdir()) == [name]
