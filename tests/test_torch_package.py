"""Package rules of the PyTorch port.

- No module of instantvnr_torch, and not chip_smoke.py, imports jax or
  instantvnr_tpu (checked on the source with ast, so lazy imports inside
  functions count too).
- Entry points default to the card: built without a device on a machine
  without CUDA they raise instead of running on the CPU.
- A kernel wrapper given CPU tensors takes its plain version and never
  builds or loads the CUDA library.
"""
import ast
import glob
import os

import numpy as np
import pytest
import torch

from instantvnr_torch import api
from instantvnr_torch.config import ModelConfig, NetworkConfig
from instantvnr_torch.ops import brick_sample as bs
from instantvnr_torch.ops import cuda_lib
from instantvnr_torch.ops import fused_mlp as fm
from instantvnr_torch.ops import hash_encoding as he
from instantvnr_torch.ops import iso_sweep as isw
from instantvnr_torch.ops import isosurface as mt
from instantvnr_torch.ops import pathtrace as opt
from instantvnr_torch.ops import slab_composite as sc
from instantvnr_torch.render import raymarch as rm

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "instantvnr_tpu")


def _port_sources():
    files = sorted(glob.glob(os.path.join(ROOT, "instantvnr_torch", "**",
                                          "*.py"), recursive=True))
    files.append(os.path.join(ROOT, "chip_smoke.py"))
    return files


def _imported_roots(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "id", None) == "__import__"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


def test_port_never_imports_jax_or_the_reference():
    files = _port_sources()
    assert len(files) > 20 and os.path.exists(files[-1])
    names = {os.path.relpath(p, ROOT) for p in files}
    assert {os.path.join("instantvnr_torch", "bench.py"),
            os.path.join("instantvnr_torch", "apps", "vnr_cmd_render.py"),
            os.path.join("instantvnr_torch", "render", "renderer.py"),
            os.path.join("instantvnr_torch", "render", "pathtrace.py"),
            os.path.join("instantvnr_torch", "render", "brickcache.py"),
            os.path.join("instantvnr_torch", "ops", "pathtrace.py"),
            os.path.join("instantvnr_torch", "ops", "brick_sample.py"),
            os.path.join("instantvnr_torch", "ops", "isosurface.py"),
            os.path.join("instantvnr_torch", "data", "outofcore.py"),
            os.path.join("instantvnr_torch", "data", "procedural.py"),
            os.path.join("instantvnr_torch", "bench_multichip.py")
            } | {os.path.join("instantvnr_torch", "parallel", f"{m}.py")
                 for m in ("__init__", "mesh", "train", "tp", "ep", "render",
                           "slab", "inspect")} <= names
    bad = [(os.path.relpath(p, ROOT), m) for p in files
           for m in _imported_roots(p) if m in FORBIDDEN]
    assert bad == []


def test_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        api.NeuralVolume(ModelConfig(), dims=(32, 32, 32))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        api.SimpleVolume.synthetic((16, 16, 16))
    from instantvnr_torch.data.procedural import AnalyticSampler
    from instantvnr_torch.data.volume import synthetic_volume

    vol = synthetic_volume((8, 8, 8), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        api.SimpleVolume([vol, vol])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        AnalyticSampler.create("tubes").lattice_grid((8, 8, 8))
    nv = api.NeuralVolume(ModelConfig(), dims=(16, 16, 16), device="cpu")
    from instantvnr_torch.render.decoded import DecodedRenderer

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DecodedRenderer(8, 8, nv.macrocell, None, (16, 16, 16))
    # the parallel package: meshes, rank devices and the train states of
    # a mesh on the card; the group launcher
    from instantvnr_torch.models.network import NeuralField
    from instantvnr_torch.parallel import ep, mesh, tp

    for fn in (mesh.make_mesh, mesh.rank_device, mesh.init_distributed,
               ep.make_expert_mesh):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            fn()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mesh.spawn(print, 1)
    field = NeuralField.from_config(ModelConfig())
    card = mesh.Mesh(shape={"data": 1, "model": 1, "expert": 1},
                     index={"data": 0, "model": 0, "expert": 0}, groups={},
                     device=torch.device("cuda"))
    for fn in (tp.create_tp_train_state, ep.create_ep_train_state):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            fn(field, card)


def test_unported_modes_raise_naming_roadmap():
    cfg = ModelConfig(network=NetworkConfig(n_neurons=16, n_hidden_layers=1))
    from instantvnr_torch.config import EncodingConfig

    cfg = ModelConfig(encoding=EncodingConfig(n_levels=2,
                                              n_features_per_level=2,
                                              log2_hashmap_size=8),
                      network=cfg.network)
    nv = api.NeuralVolume(cfg, dims=(16, 16, 16), device="cpu")
    # every RenderMode is ported; the ground-truth modes need a
    # SimpleVolume
    for mode in (api.RenderMode.FULL_SHADOW_REFERENCE,
                 api.RenderMode.PATHTRACE_REFERENCE):
        with pytest.raises(ValueError, match="SimpleVolume"):
            api.VNRenderer(nv, 8, 8, mode)
    r = api.VNRenderer(nv, 8, 8)
    # native .npz checkpoints hold either family
    # (tests/test_torch_native_ckpt.py, tests/test_torch_fvsrn.py)
    # an eye inside the volume looking back along the principal axis has
    # no slab factorization: the slab path's wavefront fallback and the
    # isosurface's brute-force marcher render it
    from instantvnr_torch.render.camera import Camera

    back = Camera(eye=(0.0, 0.0, 2.0), center=(0.0, 0.0, 6.0), up=(0, 1, 0),
                  fovy=179.0)
    r_iso = api.VNRenderer(nv, 8, 8, api.RenderMode.ISOSURFACE_DECODED)
    for renderer in (r, r_iso):
        renderer.set_camera(back)
        renderer.render()
        assert np.isfinite(renderer.mapframe()).all()
    # the decoded-slab knobs belong to DECODED_SLAB
    with pytest.raises(ValueError, match="DECODED_SLAB"):
        r_iso.set_slab_shading("gradient")


def test_cpu_wrappers_never_build(monkeypatch):
    def refuse():
        raise AssertionError("a CPU call reached the CUDA library")

    monkeypatch.setattr(cuda_lib, "load_library", refuse)
    monkeypatch.setattr(cuda_lib, "_build", refuse)
    rng = np.random.default_rng(0)
    ws = [torch.from_numpy(rng.standard_normal((16, 16)).astype(np.float32)),
          torch.from_numpy(rng.standard_normal((16, 1)).astype(np.float32))]
    x = torch.from_numpy(rng.standard_normal((33, 16)).astype(np.float32))
    counters = (fm.counter, fm.train_forward_counter, fm.backward_counter,
                he.counter, he.backward_counter, sc.counter, sc.ext_counter,
                isw.counter, rm.emit_counter, rm.emit_backward_counter,
                opt.track_counter, opt.resolve_counter, bs.counter,
                mt.counter)
    before = [c.launches for c in counters]
    y = fm.fused_mlp_apply(ws, x, NetworkConfig(n_neurons=16,
                                                n_hidden_layers=1))
    assert y.shape == (33, 1)
    # the training forms: the fused MLP's and the hash grid's backward
    from instantvnr_torch.config import EncodingConfig

    spec = he.HashGridSpec.from_config(EncodingConfig(
        n_levels=2, n_features_per_level=8, log2_hashmap_size=8))
    table = torch.zeros((spec.n_entries, 8), requires_grad=True)
    feats = he.hash_encode(table, torch.rand((33, 3)), spec,
                           compute_dtype=torch.bfloat16)
    wt = [w.clone().requires_grad_() for w in ws]
    fm.fused_mlp_apply(wt, feats, NetworkConfig(
        n_neurons=16, n_hidden_layers=1)).sum().backward()
    assert table.grad is not None and all(w.grad is not None for w in wt)
    d, hi, wi, ay, ax = 3, 5, 6, 4, 4
    f = lambda *s: torch.from_numpy(rng.random(s).astype(np.float32))  # noqa
    ctrl = torch.zeros((4, 8))
    ctrl[:, 0] = torch.tensor([0.0, 1.0, 1.0, 1.0])
    ctrl[1:, 4] = 1.0
    ctrl[:, 6] = 1.0
    def pairs(n, n_in):  # the compositors' per-row (j0, weights)
        return (torch.randint(0, n_in - 1, (d, n), dtype=torch.int32),
                f(d, n, 2))

    color, alpha = sc.composite_slabs(f(d, ay, ax), pairs(hi, ay),
                                      pairs(wi, ax), torch.ones(d, hi),
                                      torch.ones(d, wi), f(hi, wi), ctrl)
    assert color.shape == (hi, wi, 3) and alpha.shape == (hi, wi)
    fields = f(d, 4, ay, ax)
    misc = torch.tensor([0.35, 0.95, 0.6, 0.7, 0.4, 2.0, 2.0, -9.0, 1.0, 1.0,
                         1.0])
    color, _ = sc.composite_slabs_ext(
        fields, f(d, ay, ax), pairs(hi, ay), pairs(wi, ax), torch.ones(d, hi),
        torch.ones(d, wi), f(hi, wi), f(d, wi), f(d, hi), f(d), ctrl, misc,
        (0, 1, 2))
    assert color.shape == (hi, wi, 3)
    found, hit_z, hit_g = isw.iso_sweep(fields, pairs(hi, ay), pairs(wi, ax),
                                        torch.ones(d, hi), torch.ones(d, wi),
                                        0.5)
    assert found.shape == hit_z.shape == (hi, wi) and hit_g.shape == (hi, wi,
                                                                     3)
    # the wavefront's emission: the plain _emit_samples
    from instantvnr_torch.accel import macrocell as mcmod

    mc = mcmod.build(torch.rand((20, 20, 20)), (20, 20, 20))
    mc = mcmod.MacroCell(mc.value_lo, mc.value_hi,
                         torch.ones_like(mc.value_lo), mc.volume_dims)
    r = 40
    org = torch.full((r, 3), -5.0)
    dirn = torch.nn.functional.normalize(torch.rand((r, 3)) + 0.5, dim=-1)
    state = rm.init_ray_state(torch.full((r,), 5.0), torch.full((r,), 30.0))
    _, t_x, t_y, valid = rm.raymarch_emit(org, dirn, torch.full((r,), 30.0),
                                          state, mc, 1.0, 8, 8)
    assert t_x.shape == t_y.shape == valid.shape == (r, 8) and valid.any()
    # its gradient in the rays: autograd of the plain emission
    leaf = dirn.clone().requires_grad_()
    rm.raymarch_emit(org, leaf, torch.full((r,), 30.0), state, mc, 1.0, 8,
                     8)[2].sum().backward()
    assert torch.isfinite(leaf.grad).all() and leaf.grad.abs().max() > 0
    # the path tracer's event and the brick pool's sample
    track = opt.pt_track(org, dirn, state.t, torch.full((r,), 30.0),
                         torch.ones(r), mc.max_opacity, (20, 20, 20), 1.0, 2)
    assert track[5].shape == (r, 3)
    nxt = opt.pt_resolve(
        org, dirn, torch.full((r,), 30.0), torch.ones((r, 3)),
        torch.zeros((r, 3)), torch.zeros(r, dtype=torch.int32),
        torch.zeros(r, dtype=torch.bool), torch.ones(r, dtype=torch.bool),
        *track[:5], torch.rand(r), torch.rand((6, r)), ctrl, None,
        torch.ones(15), 1.0, 1.5)
    assert len(nxt) == 10 and nxt[7].dtype == torch.int32
    lut = torch.tensor([0, -1], dtype=torch.int32)
    vals = bs.brick_sample(lut, torch.rand((8000, 8)), torch.rand((r, 3)),
                           (32, 16, 16), (2, 1, 1))
    assert vals.shape == (r,)
    # marching tetrahedra: the plain dense emission and its masked gather
    tris, ids = mt.extract_slab(torch.rand((5, 6, 7)), 0.5, 3)
    assert tris.shape[1:] == (3, 3) and ids.shape[1:] == (3, 4)
    assert len(tris) > 0
    assert [c.launches for c in counters] == before


def test_loader_is_lazy():
    """Importing every module of the port builds and loads nothing: the
    CUDA library is loaded only from a wrapper given CUDA tensors."""
    import subprocess
    import sys

    code = (
        "import glob, importlib, os\n"
        "for p in sorted(glob.glob('instantvnr_torch/**/*.py', "
        "recursive=True)):\n"
        "    importlib.import_module(p[:-3].replace(os.sep, '.')"
        ".removesuffix('.__init__'))\n"
        "from instantvnr_torch.ops import cuda_lib\n"
        "assert cuda_lib.load_library.cache_info().currsize == 0\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)
    srcs = [os.path.basename(p) for p in cuda_lib._sources()]
    assert {"fused_mlp.cu", "hash_encode.cu", "slab_composite.cu",
            "iso_sweep.cu", "raymarch_emit.cu", "pathtrace.cu",
            "brick_sample.cu", "isosurface.cu", "compaction.cu",
            "adam.cu"} <= set(srcs)
    assert set(cuda_lib.SIGNATURES) == {
        "fused_mlp_forward", "fused_mlp_train_forward", "fused_mlp_backward",
        "hash_encode_forward", "hash_encode_backward",
        "hash_encode_coords_backward", "slab_composite_forward",
        "slab_composite_ext_forward",
        "iso_sweep_forward", "raymarch_emit", "raymarch_emit_backward",
        "pt_track", "pt_resolve",
        "brick_sample", "mt_count", "mt_emit", "compact_rows",
        "scatter_rows", "adam_step"}


def test_ctypes_signatures_match_sources():
    """Each C entry point's ctypes argtypes (cuda_lib.SIGNATURES) match the
    parameter list of its definition in csrc/ (the card is the only place
    the library is built, so a mismatch would show only there)."""
    import ctypes
    import re

    kinds = {"void*": ctypes.c_void_p, "int": ctypes.c_int,
             "float": ctypes.c_float, "longlong": ctypes.c_longlong}
    defs = {}
    for path in cuda_lib._sources():
        with open(path) as f:
            src = f.read()
        for name, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)',
                                       src):
            types = []
            for p in params.split(","):
                t = " ".join(p.split()[:-1]).replace("const ", "")
                types.append(kinds[t.replace(" ", "")])
            defs[name] = tuple(types)
    assert set(cuda_lib.SIGNATURES) <= set(defs)
    for name, argtypes in cuda_lib.SIGNATURES.items():
        assert tuple(argtypes) == defs[name], name


# Top-level public names of the JAX package that the port leaves out on
# purpose (ROADMAP Queue 1 "Not ported on purpose"), by JAX module
OMITTED_NAMES = {
    # v5e strategies: K3 and K4 stand for the splat (config.py)
    "ops/hash_encoding.py": {"hash_encode_splat"},
    # the Pallas kernel's v5e tile height: the CUDA kernels size their own
    # blocks
    "ops/pallas/slab_composite.py": {"pick_tile_h"},
    # names JAX primitives; the port counts its own collectives
    "parallel/inspect.py": {"COLLECTIVE_PRIMS"},
    # a v5e gather saving that brick_sample has no use for
    "render/brickcache.py": {"emission_parity_handle"},
    # the port's fingerprint, fused_lookup and FusedFrame.capture
    "render/compaction.py": {"compile_frame_async", "shape_fingerprint"},
    # StackTimer printed a host time that no caller read: the port's
    # stages are spans (span, span_summary), kept while a profiler
    # records; FPSCounter's exponential smoothing hid a stall in the rate
    # it gave, and nothing read it either
    "utils/profiling.py": {"StackTimer", "FPSCounter"},
}


def _top_level_names(path, with_imports=False):
    """Public names a module defines at its top level (functions, classes,
    assignments), and with_imports the names it imports there too."""
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    out = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            out |= {n.id for t in targets for n in ast.walk(t)
                    if isinstance(n, ast.Name)}
        elif with_imports and isinstance(node, (ast.Import, ast.ImportFrom)):
            out |= {(a.asname or a.name).split(".")[0] for a in node.names}
    return {n for n in out if not n.startswith("_")}


def _jax_modules(group):
    base = os.path.join(ROOT, "instantvnr_tpu")
    paths = sorted(glob.glob(os.path.join(base, "**", "*.py"),
                             recursive=True))
    rels = [os.path.relpath(p, base) for p in paths]
    return [r for r in rels if (os.path.dirname(r).split(os.sep)[0]
                                or "top") == group]


@pytest.mark.parametrize("group", ["top", "accel", "data", "models", "ops",
                                   "parallel", "render", "utils"])
def test_every_public_name_has_its_twin(group):
    """Every top-level public name of each JAX module exists in its port
    module (the same path; the Pallas modules' twins are ops/<name>.py),
    apart from OMITTED_NAMES, each of which the JAX module still has."""
    rels = _jax_modules(group)
    assert rels
    for rel in rels:
        jax_names = _top_level_names(os.path.join(ROOT, "instantvnr_tpu",
                                                  rel))
        twin = rel.replace(os.path.join("ops", "pallas", ""),
                           os.path.join("ops", ""))
        path = os.path.join(ROOT, "instantvnr_torch", twin)
        assert os.path.exists(path), f"{rel} has no port module {twin}"
        omitted = OMITTED_NAMES.get(rel, set())
        assert omitted <= jax_names, rel
        missing = jax_names - omitted - _top_level_names(path, True)
        assert not missing, f"{twin} lacks {sorted(missing)} of {rel}"
