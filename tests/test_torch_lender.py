"""PyTorch port, the budget of host tensors lent to callers
(``ops.staging.Lender``), which the synchronous decode on a card uses to
hand out its result in pinned memory. Without a card the same helper
lends CPU tensors: each counts its block, the request rounded up to a
power of two, until the last tensor or numpy array over its memory
dies.
"""

import sys
import threading

import numpy as np
import pytest
import torch

from trpx_tpu_torch.native import codec as ncodec
from trpx_tpu_torch.ops import coding, staging
from trpx_tpu_torch.runtime import metrics


def test_the_budget_is_a_gibibyte():
    """Four blocks of a gibibyte: a movie of 40 Gatan K3 frames (5760x4092
    u8) takes one."""
    assert staging.PINNED_RESULT_BYTES == 4 << 30
    assert isinstance(staging.RESULTS, staging.Lender)


def test_movies_held_while_the_next_is_lent():
    """At the budget's scale over 2**20: a consumer holds two movies' results
    (the one it processes, one a check keeps) while a third decodes, and
    still a fourth; a fifth would pass the budget."""
    scale = 1 << 20
    movie = 40 * 5760 * 4092 // scale
    budget = staging.PINNED_RESULT_BYTES // scale
    lender = staging.Lender()
    held = [lender.take((movie,), torch.uint8, False, budget)
            for _ in range(2)]
    assert lender.lent == 2 * 1024
    third = lender.take((movie,), torch.uint8, False, budget)
    assert third is not None and lender.lent == 3 * 1024
    fourth = lender.take((movie,), torch.uint8, False, budget)
    assert fourth is not None and lender.lent == budget
    assert lender.take((movie,), torch.uint8, False, budget) is None
    del held, third, fourth
    assert lender.lent == 0


@pytest.mark.parametrize("shape,dtype,block", [
    ((1,), torch.uint8, 1), ((3, 4), torch.int32, 64),
    ((16,), torch.int32, 64), ((65,), torch.uint8, 128),
    ((4362, 4148), torch.int32, 128 << 20)])
def test_a_loan_counts_its_block_until_it_dies(shape, dtype, block):
    lender = staging.Lender()
    t = lender.take(shape, dtype, False, 1 << 30)
    assert t.shape == shape and t.dtype == dtype and not t.is_pinned()
    assert lender.lent == block
    del t
    assert lender.lent == 0


def test_views_keep_the_memory_lent():
    """The array a decode returns is a view of the lent tensor's memory
    (numpy's view of a torch tensor holds a tensor of its own over the
    same storage): the loan ends when the last view dies, whatever
    tensor or array died first."""
    lender = staging.Lender()
    t = lender.take((2, 6), torch.int32, False, 1 << 20)
    t.copy_(torch.arange(12, dtype=torch.int32).view(2, 6))
    arr = t.numpy()
    view = arr.view(np.uint32).reshape(2, 3, 2)[1]
    again = torch.from_numpy(view)
    del t, arr
    assert lender.lent == 64
    np.testing.assert_array_equal(view.reshape(-1), np.arange(6, 12))
    del view
    assert lender.lent == 64
    assert again.tolist() == [[6, 7], [8, 9], [10, 11]]
    del again
    assert lender.lent == 0


def test_a_copy_of_a_loan_ends_it():
    """Where narrowing copies, the lent tensor is only the copy's source:
    the loan ends with it, while the copy lives on."""
    lender = staging.Lender()
    t = lender.take((8,), torch.uint16, False, 1 << 20)
    t.copy_(torch.tensor([0, 1, 254, 255, 256, 1000, 65535, 7],
                         dtype=torch.uint16))
    out = coding.narrow_values(t.numpy(), np.uint8)
    del t
    assert lender.lent == 0
    assert out.tolist() == [0, 1, 254, 255, 255, 255, 255, 7]


def test_over_the_budget_nothing_is_lent():
    lender = staging.Lender()
    held = [lender.take((16,), torch.int32, False, 128) for _ in range(2)]
    assert lender.lent == 128
    assert lender.take((1,), torch.uint8, False, 128) is None
    assert lender.lent == 128
    held.pop()
    assert lender.take((16,), torch.int32, False, 128) is not None
    # the tensor taken above died at once
    assert lender.lent == 64
    held.clear()
    assert lender.lent == 0


def test_a_failed_allocation_lends_nothing(monkeypatch):
    def refuse(*args, **kwargs):
        raise RuntimeError("no memory")

    lender = staging.Lender()
    monkeypatch.setattr(staging.torch, "empty", refuse)
    with pytest.raises(RuntimeError, match="no memory"):
        lender.take((4,), torch.int32, False, 1 << 20)
    assert lender.lent == 0


def test_loans_from_four_threads_stay_within_the_budget():
    """Four threads take, hold and drop loans of several sizes at once,
    with the interpreter switching threads often: the bytes lent never
    pass the budget, the budget refuses some loans, and once every loan
    has died nothing is counted as lent (a lost update would leave a
    count behind)."""
    lender = staging.Lender()
    budget = 1 << 12
    start = threading.Barrier(4)
    errors, refused = [], []

    def run(t):
        try:
            rng = np.random.default_rng(t)
            held = []
            start.wait()
            for _ in range(400):
                numel = int(rng.integers(1, 300))
                x = lender.take((numel,), torch.int32, False, budget)
                if x is None:
                    refused.append(t)
                else:
                    x.fill_(t)
                    held.append(x.numpy()[: numel // 2 + 1])
                assert lender.lent <= budget
                assert lender.lent > 0 or not held
                if len(held) > 2 or (held and rng.random() < 0.5):
                    view = held.pop(int(rng.integers(0, len(held))))
                    assert (view == t).all()
        except Exception as e:   # reported below with the thread
            errors.append((t, e))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=run, args=(t,))
                   for t in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads)
    assert errors == []
    assert refused
    assert lender.lent == 0


def test_the_cpu_decode_lends_nothing():
    """A decode on a CPU device returns the plain version's output: no
    loan, no ``results.*`` count, nothing pinned."""
    rng = np.random.default_rng(5)
    fr = rng.poisson(3.0, (2, 600)).astype(np.uint32)
    arch = ncodec.encode(fr)
    lent, pinned = staging.RESULTS.lent, staging.pinned_total()
    before = metrics.counters()
    out = coding.decode(arch, np.uint32, device="cpu")
    after = metrics.counters()
    np.testing.assert_array_equal(out, fr)
    assert staging.RESULTS.lent == lent
    changed = {k for k, v in after.items() if v != before.get(k, 0)}
    assert not [k for k in changed
                if k.startswith(("results.", "pinned_bytes."))]
    assert staging.pinned_total() == pinned
