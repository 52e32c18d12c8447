"""The ``tol`` early stop of ``run_consensus``: the loop ends at the first
poll of the freeze mask that finds every column frozen, and its x̄ and
every history leaf are bit for bit those of the masked loop run to the cap
(``oracle`` below, the loop as it was before the stop). On the CPU each
poll is read at once, in place, so the epochs run follow from the freeze
epochs and ``POLL_EVERY`` exactly. On a scripted card the host's lead stays
within ``MAX_LEAD`` epochs. The card test does the same on a CUDA device and
checks that the host waits on no more than a poll's event, once per poll.

Small sizes, on the CPU: m = 200, n = 64, J = 8 wide blocks, k = 4.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import consensus, dapc, prepare, prepared
from repro_torch.core.consensus import _block_col, block_residual_sq
from repro_torch.core.partition import block_rhs
from repro_torch.kernels.residual.ref import match_rhs

M, N, J, K, CAP, TOL = 200, 64, 8, 4, 200, 1.0
KW = dict(num_blocks=J, mode="wide", materialize_p=False, use_kernels=True)


def oracle(x0s, apply_fn, gamma, eta, num_epochs, x_ref=None, blocks=None, bvecs=None,
           avg_every=1, compress=None, tol=None, block_history=False, **_):
    """The masked loop run to the cap, every epoch recomputed."""
    def metrics(xb):
        out = {}
        if x_ref is not None:
            d = xb - (x_ref[..., None] if xb.ndim > x_ref.ndim else x_ref)
            out["mse"] = torch.mean(d * d, dim=0)
        if block_history:
            r = blocks @ xb - match_rhs(bvecs, xb)
            out["block_residual_sq"] = per_block = torch.sum(r * r, dim=1)
            out["residual_sq"] = torch.sum(per_block, dim=0)
        else:
            out["residual_sq"] = block_residual_sq(blocks, bvecs, xb)
        return out

    xbar = torch.mean(x0s, dim=0)
    xs, init = x0s, metrics(xbar)
    hist = {key: torch.empty((num_epochs,) + v.shape, dtype=v.dtype, device=v.device)
            for key, v in init.items()}
    vec = isinstance(eta, torch.Tensor) and eta.ndim >= 1
    gam, eta_col = _block_col(gamma, x0s.ndim), _block_col(eta, x0s.ndim)
    resid = init["residual_sq"]
    for t in range(num_epochs):
        xs_new = xs + gam * apply_fn(xbar[None] - xs)
        if (t + 1) % avg_every != 0:
            xbar_new = xbar
        elif compress == "bf16_delta" and vec:
            delta = torch.mean(eta_col * (xs_new - xbar[None]), dim=0)
            xbar_new = xbar + delta.to(torch.bfloat16).to(xbar.dtype)
        elif compress == "bf16_delta":
            delta = torch.mean(xs_new - xbar[None], dim=0)
            xbar_new = xbar + eta * delta.to(torch.bfloat16).to(xbar.dtype)
        elif vec:
            xbar_new = torch.mean(eta_col * xs_new, dim=0) + (1.0 - eta.mean()) * xbar
        else:
            xbar_new = eta * torch.mean(xs_new, dim=0) + (1.0 - eta) * xbar
        if tol is not None:
            active = resid > tol * tol
            xs_new, xbar_new = torch.where(active, xs_new, xs), torch.where(active, xbar_new, xbar)
        out = metrics(xbar_new)
        for key, v in out.items():
            hist[key][t] = v
        resid, xs, xbar = out["residual_sq"], xs_new, xbar_new
    hist["initial"] = init
    return xbar, hist


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def system():
    rng = np.random.default_rng(5)
    A = rng.standard_normal((M, N)).astype(np.float32)
    X = rng.standard_normal((N, K)).astype(np.float32)
    return A, X, rng.standard_normal(M).astype(np.float32), prepare(A, **KW, device="cpu")


def _inputs(prep, B):
    """What ``PreparedSolver.solve`` hands ``run_consensus`` for ``B``."""
    bvecs = block_rhs(prep.mixer, B, prep.blocks.dtype, prep.device)
    Ws, Rs = prep.factors
    x0s = dapc.initial_from_factors(Ws, Rs, bvecs, prep.mode, prep.use_kernels)
    kind, operand = prep.projector
    return x0s, dapc.make_apply(operand, False, use_kernels=kind == "kernels"), bvecs


def _same_bits(a, b):
    assert a.shape == b.shape and a.dtype == b.dtype
    assert torch.equal(a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))


def _leaves(hist):
    """A history's leaves by name, the initial row's as ``initial.<key>``."""
    out = {f"initial.{key}": v for key, v in hist["initial"].items()}
    out.update((key, v) for key, v in hist.items() if key != "initial")
    return out


def _same_result(got_x, got, want_x, want):
    """x̄ and every history leaf, bit for bit."""
    _same_bits(got_x, want_x)
    got, want = _leaves(got), _leaves(want)
    assert sorted(got) == sorted(want)
    for key in want:
        _same_bits(got[key], want[key])


def _expected_epochs(hist, tol, cap):
    """The first poll (after epoch m, m a multiple of ``POLL_EVERY`` below
    the cap) whose row has no residual above tol², else the cap."""
    rows = hist["residual_sq"].reshape(cap, -1)
    c = consensus.POLL_EVERY
    return next((m for m in range(c, cap, c) if not (rows[m - 1] > tol * tol).any()), cap)


CASES = {
    "batched": {},
    "single_rhs": {"single": True},
    "avg_every_2": {"avg_every": 2},
    "bf16_delta": {"compress": "bf16_delta"},
    "per_block_dynamics": {"per_block": True},
    "block_history_and_mse": {"block_history": True, "x_ref": True},
    "per_block_bf16_delta": {"per_block": True, "compress": "bf16_delta"},
    "nan_column": {"last": "nan"},
    "never_freezes": {"last": "inconsistent"},
    "no_tol": {"tol": None},
}


@pytest.mark.parametrize("case", list(CASES))
def test_stops_at_the_first_poll_after_the_last_freeze_bit_for_bit(system, case):
    A, X, off_range, prep = system
    opts = dict(CASES[case])
    B = A @ X
    if opts.pop("last", None) == "nan":
        B[:, -1] = np.nan
    elif "last" in CASES[case]:
        B[:, -1] = off_range  # off the range of A: its residual stays above tol²
    x_ref = X
    if opts.pop("single", False):
        B, x_ref = B[:, 0], X[:, 0]
    x0s, apply_fn, bvecs = _inputs(prep, B)
    gamma, eta = torch.tensor(1.0), torch.tensor(0.9)
    if opts.pop("per_block", False):
        gamma, eta = torch.linspace(0.8, 1.2, J), torch.linspace(0.7, 1.0, J)
    if opts.pop("x_ref", False):
        opts["x_ref"] = torch.as_tensor(x_ref)
    tol = opts.pop("tol", TOL)
    args = (x0s, apply_fn, gamma, eta, CAP)
    kwargs = dict(blocks=prep.blocks, bvecs=bvecs, tol=tol, **opts)
    want_x, want = oracle(*args, **kwargs)
    stats = {}
    got_x, got = consensus.run_consensus(*args, **kwargs, stats=stats)
    _same_result(got_x, got, want_x, want)
    if tol is None:
        assert stats == {"epochs": CAP, "poll_bytes": 0, "lead_waits": 0}
        return
    ran = _expected_epochs(want, tol, CAP)
    # the CPU reads each flag in place: nothing copied, nothing waited for
    assert stats == {"epochs": ran, "poll_bytes": 0, "lead_waits": 0}
    if case == "never_freezes":
        assert ran == CAP
        final = want["residual_sq"][-1]
        assert final[-1] > tol * tol and (final[:-1] <= tol * tol).all()
    else:
        assert ran <= CAP // 2  # every column froze well before the cap


class _ScriptedCard:
    """The stream's pinned flags and events as ``_FreezePoll`` sees them on
    a CUDA device, on a scripted card that runs ``speed`` epochs for each
    epoch the host issues (never past the last one issued). A poll's flag
    lands, and its event completes, once the card has run the poll's epoch;
    a wait on an event runs the card up to it; a flag read before it lands
    fails the test."""

    def __init__(self, speed: float):
        self.speed, self.done, self.issued = speed, -1.0, -1
        self.copies, self.waits = {}, []  # slot: (epoch, flag); per wait: was it complete
        self.flags_copied = 0
        card = self

        class Slot:
            def __init__(self, i):
                self.i = i

            def copy_(self, src, non_blocking=False):
                assert non_blocking
                card.copies[self.i] = (card.issued, bool(src))
                card.flags_copied += 1

        class Event:
            epoch = None

            def record(self, stream):
                self.epoch = card.issued

            def query(self):
                return card.done >= self.epoch

            def synchronize(self):
                card.waits.append(self.query())
                card.done = max(card.done, self.epoch)

        class View:
            def __getitem__(self, i):
                epoch, flag = card.copies[i]
                assert card.done >= epoch, "a flag read before its copy landed"
                return flag

        slots = range(consensus._POLL_SLOTS)
        self.buffer = [Slot(i) for i in slots], View(), [Event() for _ in slots]

    def issue(self, t: int):
        """The host has queued epoch ``t``; the card runs on meanwhile."""
        self.issued = t
        self.done = min(float(t), self.done + self.speed)


LEAD_CASES = {  # the epoch each column freezes at (runs that many epochs); None: never
    "freeze_early": [5, 9, 12, 14],
    "freeze_late": [40, 61, 77, 79],
    "never_freezes": [20, 30, 40, None],
    "single_rhs": 33,
}


@pytest.mark.parametrize("speed", [1.0, 0.5, 0.2], ids=["keeps_up", "half", "fifth"])
@pytest.mark.parametrize("case", list(LEAD_CASES))
def test_the_host_leads_the_card_by_at_most_max_lead(monkeypatch, case, speed):
    """``_FreezePoll.frozen`` driven as ``run_consensus`` drives it, through
    scripted masks on a scripted card: the host never issues an epoch more
    than ``MAX_LEAD + POLL_EVERY`` past the oldest poll it has not read, nor
    past the card; it stops at the first poll that reads every column
    frozen, or at most ``MAX_LEAD`` epochs after it; it waits only on
    events not yet complete, and counts each such wait."""
    card = _ScriptedCard(speed)
    monkeypatch.setattr(consensus, "_poll_buffer", lambda stream: card.buffer)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: "stream")
    freeze = LEAD_CASES[case]
    f = torch.tensor([float("inf") if e is None else e for e in np.atleast_1d(freeze)])
    if np.ndim(freeze) == 0:
        f = f[0]
    poll = consensus._FreezePoll(torch.device("cuda"))
    c, most = consensus.POLL_EVERY, consensus.MAX_LEAD + consensus.POLL_EVERY
    stop = None
    for t in range(CAP - 1):  # run_consensus polls after every epoch but the last
        card.issue(t)
        if poll.pending:
            assert t - card.buffer[2][poll.pending[0]].epoch <= most
        assert t - card.done <= most
        if poll.frozen(t + 1 < f, t):  # the next epoch's mask
            stop = t
            break
        assert len(poll.pending) <= consensus._POLL_SLOTS
    frozen_at = next((t for t in range(c - 1, CAP - 1, c) if not (t + 1 < f).any()), None)
    if frozen_at is None:
        assert stop is None and case == "never_freezes"
    else:
        assert frozen_at <= stop <= frozen_at + consensus.MAX_LEAD
        assert stop <= frozen_at + most - 1
        if speed == 1.0:  # every copy lands at once: the stop of the CPU
            assert stop == frozen_at
    assert poll.copied == card.flags_copied
    assert not any(card.waits)  # a wait only on an event not yet complete
    assert poll.lead_waits == len(card.waits)
    if speed == 1.0:
        assert poll.lead_waits == 0
    elif speed == 0.2:
        assert poll.lead_waits > 0  # the cap held the host back


# The profiled solve of the card test, in a child process: a CUDA profile
# taken in the test process changes what later profiles there record.
_PROFILED_SOLVE = """
import json, sys
import numpy as np, torch
from torch.profiler import ProfilerActivity, profile
from repro_torch.core import prepare
from repro_torch.obs import metrics
out, tol = sys.argv[1], float(sys.argv[2])
torch.backends.cuda.matmul.allow_tf32 = False
rng = np.random.default_rng(11)
A = rng.standard_normal((8192, 2048)).astype(np.float32)
B = A @ rng.standard_normal((2048, 32)).astype(np.float32)
prep = prepare(A, **json.loads(sys.argv[3]), device="cuda")
prep.solve(B, num_epochs=300, tol=tol)  # warm
before = metrics.REGISTRY.value("solver_epochs_total")
with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
    res = prep.solve(B, num_epochs=300, tol=tol)
prof.export_chrome_trace(out + ".json")
np.save(out + ".npy", res.history["residual_sq"])
with open(out + ".epochs", "w") as f:
    f.write(repr(metrics.REGISTRY.value("solver_epochs_total") - before))
"""


@pytest.mark.gpu
def test_on_the_card_the_stop_is_bit_for_bit_and_the_host_waits_only_on_a_poll(tmp_path):
    """A random consistent system on the card, J = 8 wide, k = 32, cap 300,
    ``tol`` at the largest residual of epoch 100: the solve stops before
    the cap and at most ``MAX_LEAD + POLL_EVERY`` epochs past the last
    freeze rounded up to a poll, its x̄ and history equal the oracle's bit
    for bit (also with two threads solving at once), and inside
    ``solver.epochs`` of a profiled solve the host waits for the device
    only on a poll's event, at most once a poll."""
    import json
    import os
    import subprocess
    import sys
    import threading
    from pathlib import Path

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    m, n, k, cap = 8192, 2048, 32, 300
    rng = np.random.default_rng(11)
    A = rng.standard_normal((m, n)).astype(np.float32)
    B = A @ rng.standard_normal((n, k)).astype(np.float32)
    prep = prepare(A, **KW, device="cuda")
    x0s, apply_fn, bvecs = _inputs(prep, B)
    args = (x0s, apply_fn, torch.tensor(1.0, device="cuda"), torch.tensor(0.9, device="cuda"), cap)
    _, free = oracle(*args, blocks=prep.blocks, bvecs=bvecs)
    tol = float(free["residual_sq"][99].max()) ** 0.5
    want_x, want = oracle(*args, blocks=prep.blocks, bvecs=bvecs, tol=tol)
    stats = {}
    got_x, got = consensus.run_consensus(*args, blocks=prep.blocks, bvecs=bvecs, tol=tol,
                                         stats=stats)
    c = consensus.POLL_EVERY
    last_freeze = int(prepared.active_epochs(
        {"residual_sq": want["residual_sq"].cpu().numpy(),
         "initial": {"residual_sq": want["initial"]["residual_sq"].cpu().numpy()}},
        cap, k, tol).max())
    most = -(-last_freeze // c) * c + consensus.MAX_LEAD + c
    assert last_freeze <= stats["epochs"] <= most and stats["epochs"] < cap
    # one flag a poll; none for the poll of the epoch the stop came at,
    # where the host read the poll MAX_LEAD back before queueing its own
    assert stats["epochs"] // c - 1 <= stats["poll_bytes"] <= stats["epochs"] // c
    _same_result(got_x, got, want_x, want)

    # two threads at once on the same stream, each polling its own buffer
    tols = (tol, 2.0 * tol)
    wants = [oracle(*args, blocks=prep.blocks, bvecs=bvecs, tol=t) for t in tols]
    gots = [None, None]

    def run(i):
        gots[i] = consensus.run_consensus(*args, blocks=prep.blocks, bvecs=bvecs, tol=tols[i])

    threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=300)
    assert not any(th.is_alive() for th in threads)
    for (gx, gh), (wx, wh) in zip(gots, wants):
        _same_result(gx, gh, wx, wh)

    root = Path(__file__).resolve().parents[1]
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(root / "src"), os.environ.get("PYTHONPATH", "")])}
    out = str(tmp_path / "solve")
    done = subprocess.run([sys.executable, "-c", _PROFILED_SOLVE, out, repr(tol), json.dumps(KW)],
                          cwd=root, env=env, capture_output=True, text=True, timeout=600)
    assert done.returncode == 0, done.stderr[-3000:]
    np.testing.assert_array_equal(np.load(out + ".npy"), want["residual_sq"].cpu().numpy())
    profiled = float(Path(out + ".epochs").read_text())
    assert last_freeze <= profiled <= most and profiled < cap
    events = [e for e in json.loads(Path(out + ".json").read_text())["traceEvents"]
              if e.get("ph") == "X"]
    (loop,) = [e for e in events if e["name"] == "solver.epochs"]
    inside = [e["name"] for e in events
              if loop["ts"] <= e["ts"] and e["ts"] + e["dur"] <= loop["ts"] + loop["dur"]]
    for sync in ("cudaStreamSynchronize", "cudaDeviceSynchronize"):
        assert sync not in inside
    assert "cudaEventQuery" in inside
    polls = [e for e in events if e["name"].startswith("Memcpy DtoH")
             and "Pinned" in e["name"]]
    assert polls and all(int(e["args"]["bytes"]) == 1 for e in polls)
    assert inside.count("cudaEventSynchronize") <= len(polls)


@pytest.mark.gpu
def test_a_wait_on_a_polls_event_leaves_the_interpreter_to_other_threads():
    """The lead cap's wait (``Event.synchronize``) releases the GIL: while a
    thread waits on an event queued behind ~1 s of device work, this thread
    keeps running Python without a pause near that long."""
    import threading
    import time

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.cuda.synchronize()
    torch.cuda._sleep(2_000_000_000)  # ~1 s of clock cycles on one SM
    event = torch.cuda.Event()
    event.record()
    assert not event.query()
    waiter = threading.Thread(target=event.synchronize)
    start = last = time.perf_counter()
    waiter.start()
    gap = 0.0
    while waiter.is_alive() and last - start < 60:
        now = time.perf_counter()
        gap, last = max(gap, now - last), now
    waiter.join(timeout=60)
    assert not waiter.is_alive() and event.query()
    assert last - start > 0.3  # the wait was long
    assert gap < 0.1
