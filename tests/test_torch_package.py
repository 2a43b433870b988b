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
from instantvnr_torch.ops import cuda_lib
from instantvnr_torch.ops import fused_mlp as fm
from instantvnr_torch.ops import hash_encoding as he
from instantvnr_torch.ops import iso_sweep as isw
from instantvnr_torch.ops import slab_composite as sc

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
    bad = [(os.path.relpath(p, ROOT), m) for p in files
           for m in _imported_roots(p) if m in FORBIDDEN]
    assert bad == []


def test_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        api.NeuralVolume(ModelConfig(), dims=(32, 32, 32))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        api.SimpleVolume.synthetic((16, 16, 16))
    nv = api.NeuralVolume(ModelConfig(), dims=(16, 16, 16), device="cpu")
    from instantvnr_torch.render.decoded import DecodedRenderer

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DecodedRenderer(8, 8, nv.macrocell, None, (16, 16, 16))


def test_unported_modes_raise_naming_roadmap():
    cfg = ModelConfig(network=NetworkConfig(n_neurons=16, n_hidden_layers=1))
    from instantvnr_torch.config import EncodingConfig

    cfg = ModelConfig(encoding=EncodingConfig(n_levels=2,
                                              n_features_per_level=2,
                                              log2_hashmap_size=8),
                      network=cfg.network)
    nv = api.NeuralVolume(cfg, dims=(16, 16, 16), device="cpu")
    for mode in (api.RenderMode.NEURAL_WAVEFRONT,
                 api.RenderMode.FULL_SHADOW_REFERENCE,
                 api.RenderMode.PATHTRACE_DECODED):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            api.VNRenderer(nv, 8, 8, mode)
    r = api.VNRenderer(nv, 8, 8)
    # training is ported; native .npz checkpoints are not
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        nv.save_params("unported.npz")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        nv.set_params("unported.npz")
    # an eye inside the volume looking back along the principal axis has
    # no slab factorization; neither the slab path's wavefront fallback
    # nor the isosurface's brute-force marcher is ported
    from instantvnr_torch.render.camera import Camera

    back = Camera(eye=(0.0, 0.0, 2.0), center=(0.0, 0.0, 6.0), up=(0, 1, 0),
                  fovy=179.0)
    r_iso = api.VNRenderer(nv, 8, 8, api.RenderMode.ISOSURFACE_DECODED)
    for renderer in (r, r_iso):
        renderer.set_camera(back)
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            renderer.render()
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
                isw.counter)
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
    found, hit_z, hit_g = isw.iso_sweep(fields, f(d, hi, ay), f(d, wi, ax),
                                        torch.ones(d, hi), torch.ones(d, wi),
                                        0.5)
    assert found.shape == hit_z.shape == (hi, wi) and hit_g.shape == (hi, wi,
                                                                     3)
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
            "iso_sweep.cu"} <= set(srcs)
    assert set(cuda_lib.SIGNATURES) == {
        "fused_mlp_forward", "fused_mlp_train_forward", "fused_mlp_backward",
        "hash_encode_forward", "hash_encode_backward",
        "slab_composite_forward", "slab_composite_ext_forward",
        "iso_sweep_forward"}


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
