"""The fused Adam's host side on the CPU: the float32 scalars the
`adam_step` kernel receives, the launch groups' table, and the dispatch
of a CPU tree to the plain form (the kernel itself is compared with the
plain form bit for bit in tests/test_torch_cuda.py, on the card)."""
import ctypes
import os
import re

import numpy as np
import pytest
import torch

from instantvnr_torch.config import OptimizerConfig
from instantvnr_torch.models import optimizer as opt
from instantvnr_torch.ops import adam as kadam
from instantvnr_torch.ops import cuda_lib

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = [1, 2, 2001, 3001]


@pytest.mark.parametrize("step", STEPS)
def test_kernel_scalars_are_the_ones_pytorch_applies(step):
    """Each factor reaches the kernel as ctypes rounds it to float32, which
    is the float32 that the plain form's foreach call multiplies by."""
    cfg = OptimizerConfig()
    s = opt.adam_scalars(cfg, step)
    for name, x in s._asdict().items():
        f = np.float32(x)
        assert ctypes.c_float(x).value == f, name
        got = torch._foreach_mul([torch.ones(1)], x)[0].item()
        assert got == f, name
    # 1 − β1 is the double rounded once, not 1 − float32(β1)
    assert np.float32(s.one_minus_beta1) == np.float32(1.0 - 0.9)
    assert np.float32(s.one_minus_beta1) != np.float32(1) - np.float32(0.9)
    assert s.lr == opt.lr_at_step(cfg, step)
    t = np.float32(step)
    assert s.c1 == float(np.float32(1) - np.float32(cfg.beta1) ** t)
    assert s.c2 == float(np.float32(1) - np.float32(cfg.beta2) ** t)
    # the decay's first stair lies between steps 2001 and 3001
    assert (s.lr < np.float32(cfg.learning_rate)) == (step > 3000)


def test_scalars_follow_the_c_entrys_parameter_order():
    with open(os.path.join(ROOT, "instantvnr_torch", "csrc", "adam.cu")) as f:
        params = re.search(r'extern "C" int adam_step\(([^)]*)\)',
                           f.read()).group(1)
    names = [p.split()[-1] for p in params.split(",")]
    assert names == ["table", "n_leaves", *kadam.AdamScalars._fields,
                     "stream"]
    assert len(cuda_lib.SIGNATURES["adam_step"]) == len(names)


def _leaf(n, offset=0):
    """A float32 leaf of n elements, `offset` floats into its buffer."""
    return torch.zeros(n + offset)[offset:]


@pytest.mark.parametrize("sizes,offsets,l2", [
    ([4096, 4096, 4096, 4096, 4096, 64], [0] * 6, [0, 1, 1, 1, 1, 1]),
    ([1, 3, 5, 1001, (1 << 20) + 3], [0, 0, 1, 0, 1], [1, 0, 1, 0, 1]),
    ([7] * 8, [0] * 8, [1, 0] * 4),
    ([9, 0, 17, 33, 4, 8, 12, 16, 20, 24, 28, 1], [0] * 12, [1, 0, 0] * 4),
], ids=["tree", "ragged", "eight", "longer"])
def test_pack_groups_puts_the_leaves_in_place(sizes, offsets, l2):
    ins = [tuple(_leaf(n, o) for _ in range(4))
           for n, o in zip(sizes, offsets)]
    outs = [tuple(torch.empty_like(t) for t in (p, m, v))
            for p, _, m, v in ins]
    groups = kadam.pack_groups(ins, outs, l2)
    kept = [i for i, n in enumerate(sizes) if n > 0]
    assert [len(g) for g in groups] == [
        min(kadam.MAX_LEAVES, len(kept) - i)
        for i in range(0, len(kept), kadam.MAX_LEAVES)]
    rows = np.concatenate(groups)
    col = {name: rows[:, j] for j, name in enumerate(kadam.FIELDS)}
    for r, i in enumerate(kept):
        arrays = (*ins[i], *outs[i])
        assert [int(rows[r, j]) for j in range(7)] == [
            t.data_ptr() for t in arrays]
        assert col["n"][r] == sizes[i]
        assert col["l2"][r] == l2[i]
        aligned = all(t.data_ptr() % 16 == 0 for t in arrays)
        assert col["vec"][r] == int(aligned)
        if offsets[i]:
            assert not aligned  # a view 4 bytes in never moves as float4
    assert rows.dtype == np.int64 and rows.flags.c_contiguous


def _tree(rng, shapes, scale=1.0):
    leaves = [torch.from_numpy(rng.standard_normal(s).astype(np.float32)
                               * scale) for s in shapes]
    return {"table": leaves[0], "mlp": leaves[1:]}


@pytest.mark.parametrize("step", STEPS)
def test_a_cpu_tree_takes_the_plain_form_and_launches_nothing(step,
                                                              monkeypatch):
    def refuse():
        raise AssertionError("a CPU tree reached the CUDA library")

    monkeypatch.setattr(cuda_lib, "load_library", refuse)
    rng = np.random.default_rng(step)
    shapes = [(300, 8), (64, 64), (64, 64), (64, 1)]
    p, g, m = (_tree(rng, shapes, k) for k in (1e-2, 1e-3, 1e-4))
    v = {k: (abs(x) if k == "table" else [abs(w) for w in x])
         for k, x in _tree(rng, shapes, 1e-3).items()}
    state = opt.AdamState(step=step - 1, mu=m, nu=v)
    before = kadam.counter.launches
    cfg = OptimizerConfig()
    new, st = opt.adam_update(cfg, p, g, state, l2_mask=opt.mlp_l2_mask(p))
    ref, rst = opt.adam_update_plain(cfg, p, g, state,
                                     l2_mask=opt.mlp_l2_mask(p))
    assert kadam.counter.launches == before
    assert st.step == rst.step == step
    for a, b in zip(opt._leaves(new) + opt._leaves(st.mu)
                    + opt._leaves(st.nu),
                    opt._leaves(ref) + opt._leaves(rst.mu)
                    + opt._leaves(rst.nu)):
        assert torch.equal(a, b)


def test_the_kernel_wrapper_refuses_what_it_does_not_take():
    p = torch.zeros(8)
    with pytest.raises(ValueError, match="CUDA"):
        kadam.adam_step([p], [p], [p], [p], [False],
                        opt.adam_scalars(OptimizerConfig(), 1))
    dev = p.device
    for bad in (p.to(torch.bfloat16), torch.zeros(16)[::2],
                torch.zeros(9), torch.zeros(2, 4)):
        with pytest.raises(ValueError, match="contiguous float32"):
            kadam._check((p, bad, p, p), dev)
    kadam._check((p, torch.zeros(8), p, p), dev)
