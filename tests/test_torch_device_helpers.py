"""The device helpers that the port's kernels share, run as compiled code.

``tests/_cuda_checks.cu`` calls them from small test kernels, built for
the card by nvcc (``gpu`` marker) and for the CPU through
``tests/_cuda_emulation``:

- ``wl::SpdInv<N>`` (``csrc/warp_linalg.cuh``): its two schedules of a
  Schur level (fused: two barriers a level; split: four) sum the same
  entries in the same order, so they must give the same bits.  Each size
  runs the top level both ways on seeded SPD matrices (below that level
  both use the default schedule), and both are held to the float64
  inverse.  N = 6 and 12 are the WBC's, 18 the model evaluation's, 28 the
  KF's S (whose top level ``kf.cu`` now takes over its block with the same
  sums as the split schedule), 14 the two inverses below it, which the KF
  runs with the split schedule.
- ``div_rn`` (``csrc/div_rn.cuh``, the plant's division): bit for bit
  against IEEE float32 division (numpy's) on seeded quotients of the
  sizes the plant divides and on divisors whose significand is all ones.
  On the card this runs the kernel's own estimate (``__fdividef``); the
  emulation's estimate is the exact quotient, so there it checks the
  refinement as compiled.
- float4 loads from dynamic shared memory filled by 16-byte ``cp.async``
  (``admm.cu``'s rhs broadcasts): the base is 16-byte aligned and every
  quad reads back the floats copied in, as each lane's own and as a
  broadcast; a size the check does not take returns cudaErrorInvalidValue.
- ``__fmul_rn`` (the products ``admm.cu`` keeps out of a contraction):
  bit for bit the IEEE float32 product (numpy's).
"""

import _cuda_checks
import _cuda_emulation
import numpy as np
import pytest
import torch

# one intra-op thread: pytest -n workers share the cores, a thread per core in each oversubscribes
torch.set_num_threads(1)

from test_torch_plant_division import _cases


@pytest.fixture(params=["cpu", pytest.param("cuda", marks=pytest.mark.gpu)])
def device(request):
    if request.param == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    if request.param == "cpu" and _cuda_emulation.compiler() is None:
        pytest.skip("needs a host C++ compiler")
    return torch.device(request.param, 0) if request.param == "cuda" else torch.device("cpu")


def _spd(rng, B, n):
    """B seeded SPD matrices, condition number ~1e2."""
    q, _ = np.linalg.qr(rng.standard_normal((B, n, n)))
    ev = 10.0 ** rng.uniform(-1, 1, (B, 1, n))
    return ((q * ev) @ q.transpose(0, 2, 1)).astype(np.float32)


@pytest.mark.parametrize("n", [6, 12, 14, 18, 28])
def test_spd_inv_schedules_agree(device, n):
    B = 3 if device.type == "cpu" else 512
    m = _spd(np.random.default_rng(n), B, n)
    M = torch.from_numpy(m).to(device)
    fused, split = torch.empty_like(M), torch.empty_like(M)
    _cuda_checks.call(_cuda_checks.load(device), f"spd_inv_{n}", M, fused, split, n=B)
    f, s = fused.cpu().numpy(), split.cpu().numpy()
    assert np.array_equal(f.view(np.uint32), s.view(np.uint32))
    want = np.linalg.inv(m.astype(np.float64))
    assert np.abs(f - want).max() / np.abs(want).max() < 1e-4


def test_div_rn_is_ieee_division(device):
    n = 1200 if device.type == "cpu" else 1 << 20
    a, b = _cases(np.random.default_rng(12), n // 2)
    out = torch.empty(a.size, dtype=torch.float32, device=device)
    _cuda_checks.call(_cuda_checks.load(device), "div_rn_check",
                      torch.from_numpy(a).to(device), torch.from_numpy(b).to(device), out,
                      n=a.size)
    want = a / b
    assert np.array_equal(out.cpu().numpy().view(np.uint32), want.view(np.uint32))


def test_float4_loads_from_dynamic_shared_memory(device):
    n = 4 * 75
    a = torch.from_numpy(np.random.default_rng(3).standard_normal(n).astype(np.float32))
    out = torch.full((n + 5,), float("nan"), device=device)
    lib = _cuda_checks.load(device)
    _cuda_checks.call(lib, "float4_smem_check", a.to(device), out, n=n)
    got = out.cpu()
    assert torch.equal(got[:n], a)
    assert torch.equal(got[n:n + 4], a[:4])
    assert float(got[n + 4]) == 0.0
    with pytest.raises(RuntimeError, match="cudaError_t 1"):
        _cuda_checks.call(lib, "float4_smem_check", a.to(device), out, n=n - 2)


def test_fmul_rn_is_the_float32_product(device):
    n = 1200 if device.type == "cpu" else 1 << 20
    rng = np.random.default_rng(14)
    a, b = (rng.standard_normal(n).astype(np.float32) * 10.0 ** rng.integers(-20, 20, n)
            for _ in range(2))
    a, b = a.astype(np.float32), b.astype(np.float32)
    out = torch.empty(n, dtype=torch.float32, device=device)
    _cuda_checks.call(_cuda_checks.load(device), "fmul_rn_check",
                      torch.from_numpy(a).to(device), torch.from_numpy(b).to(device), out, n=n)
    assert np.array_equal(out.cpu().numpy().view(np.uint32), (a * b).view(np.uint32))
