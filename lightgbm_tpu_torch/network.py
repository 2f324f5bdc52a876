"""Process wiring and the collectives of the "data" axis.

The port of the JAX package's network.py. The reference builds a TCP
or MPI collective stack from a machine list and calls Network::Init
before training (application.cpp:164-175; LGBM_NetworkInit through the
C API, c_api.cpp:2262). Here that stack is ``torch.distributed``: one
process per device, joined in the default process group. The ranks of
that group play the JAX package's ``"data"`` mesh axis: rank r owns the
rows that shard r owns there, and the world size plays the mesh size.

Launch: run the same script once per device, either under ``torchrun
--nproc_per_node=N`` (the default group is then set up by the caller,
or from ``MASTER_ADDR`` / ``RANK`` / ``WORLD_SIZE``), or with
``machines=ip1:port,ip2:port,...`` and ``num_machines=K``, the
reference's parameters: the rank is this host's index in the list
(its local addresses matched against the entries, as the reference's
socket linker does, linkers_socket.cpp:36-48), and entry 0 holds the
TCP store. Several processes on one host take their rank from ``RANK``
(or ``LGBM_TPU_RANK``). The backend is NCCL for CUDA devices and gloo
on the CPU; a group the caller initialized is used as it is.

The collectives (``psum``, ``pmax``, ``all_gather``) are identities
without a group of more than one rank. A float ``psum`` is an
``all_gather`` followed by the sum in rank order from a +0.0
accumulator, ``((0 + x0) + x1) + ...`` on every rank: the association
of the JAX package's CPU ``psum`` under ``shard_map`` (so a sum of
-0.0s is +0.0), and the same bits on every rank whatever the transport
(a ring ``all_reduce`` fixes no order). Integer sums are one
exact ``all_reduce``. Under gloo, CUDA tensors are staged through host
memory. ``STATS`` counts the calls and the bytes each rank contributes;
``set_timing(True)`` also records CUDA events around each collective
(``timed_ms`` sums them). Every collective runs inside
``collective_span``: the ``collective.dispatch`` fault seam and a
``collective:<op>`` watchdog phase, so a hang there is classified as a
collective stall (robust/), and, with telemetry on (obs/), the op's
calls, the bytes this rank contributes and its host latency in the
registry and a "collective" event on the trace timeline.
``fleet_allgather`` gathers the telemetry's small per-rank payload
(``straggler_stats``: the host skew and the slowest rank).
"""
from __future__ import annotations

import contextlib
import datetime
import os
import random
import socket
import threading
import time
from typing import List, Optional, Sequence, Tuple

import torch

from .obs import registry as _registry
from .obs import trace as _trace
from .robust.faultinject import check_fault
from .robust.watchdog import watch_phase
from .utils import log

# bring-up retry policy: a peer restarting a few seconds late must not
# kill the whole job, so the group's initialization is retried with
# exponential backoff and jitter
_INIT_RETRIES_ENV = "LGBM_TPU_INIT_RETRIES"
_DEFAULT_INIT_RETRIES = 3
_BACKOFF_BASE_S = 1.0
_BACKOFF_CAP_S = 30.0

# per-process collective accounting: calls and the bytes this rank
# contributes (its own tensor's, once per collective)
STATS = {"calls": 0, "bytes": 0}
_timing = {"on": False, "events": []}


def _dist():
    import torch.distributed as dist
    return dist


def is_active() -> bool:
    """Whether a process group of more than one rank is set up."""
    dist = _dist()
    return (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() > 1)


def world_size() -> int:
    return _dist().get_world_size() if is_active() else 1


def rank() -> int:
    return _dist().get_rank() if is_active() else 0


def backend() -> Optional[str]:
    """The default group's backend name, or None without a group."""
    dist = _dist()
    if not (dist.is_available() and dist.is_initialized()):
        return None
    return str(dist.get_backend()).lower()


def comm_device() -> torch.device:
    """Where a collective's buffers live: the current CUDA device under
    NCCL, else the host."""
    if backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def reset_stats() -> None:
    STATS["calls"] = 0
    STATS["bytes"] = 0
    _timing["events"] = []


def set_timing(on: bool) -> None:
    """Record a pair of CUDA events around every collective on a CUDA
    tensor (read with ``timed_ms``)."""
    _timing["on"] = bool(on)
    _timing["events"] = []


def timed_ms() -> float:
    """Milliseconds spent inside the timed collectives since the last
    ``set_timing`` / ``reset_stats`` (synchronizes the device)."""
    ev = _timing["events"]
    if not ev:
        return 0.0
    torch.cuda.synchronize()
    return float(sum(a.elapsed_time(b) for a, b in ev))


def _nbytes(t: torch.Tensor) -> int:
    return int(t.numel()) * t.element_size()


class _Span:
    """Accounting of one collective: its bytes, and CUDA events when
    timing is on."""

    def __init__(self, t: torch.Tensor) -> None:
        STATS["calls"] += 1
        STATS["bytes"] += _nbytes(t)
        self.ev = None
        if _timing["on"] and t.is_cuda:
            self.ev = (torch.cuda.Event(enable_timing=True),
                       torch.cuda.Event(enable_timing=True))

    def __enter__(self):
        if self.ev is not None:
            self.ev[0].record()
        return self

    def __exit__(self, *exc):
        if self.ev is not None:
            self.ev[1].record()
            _timing["events"].append(self.ev)
        return False


def _staged(t: torch.Tensor) -> Tuple[torch.Tensor, bool]:
    """(tensor to hand the backend, whether it was staged to the host):
    gloo takes CUDA tensors through host memory."""
    if t.is_cuda and backend() == "gloo":
        # tpulint: sync-ok(gloo only: the backend takes CUDA tensors via the host)
        return t.cpu(), True
    return t, False


@contextlib.contextmanager
def collective_span(op: str, nbytes: int = 0, axis: str = "data"):
    """One collective dispatch (the JAX package's collective_span): a
    ``collective:<op>`` phase of the active watchdog, so a hang inside
    is classified as a "collective" stall and leaving it is a
    cooperative check point, around the ``collective.dispatch`` fault
    seam. With an active registry or tracer (obs/) it records the call,
    ``nbytes`` (the bytes this rank contributes, as ``STATS`` counts
    them) on ``axis`` and the host latency; free when neither is on."""
    with watch_phase(f"collective:{op}"):
        check_fault("collective.dispatch")
        reg = _registry.active()
        tr = _trace.active_tracer()
        if reg is None and tr is None:
            yield
            return
        tr_t0 = tr.now_ns() if tr is not None else 0
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            if reg is not None:
                reg.record_collective(op, nbytes, dt, axis=axis)
            if tr is not None:
                args = {"bytes": int(nbytes)}
                if axis:
                    args["axis"] = axis
                tr.complete(op, "collective", tr_t0, tr.now_ns(), args)


def straggler_skew(seconds: float) -> float:
    """Cross-rank skew gauge for one iteration: every rank contributes
    its wall time, and the gauge is (max - min) / mean over the ranks —
    0.0 means lockstep. One process returns 0.0 without touching the
    group. This is itself a host barrier (an all_gather), so it runs
    only on the telemetry path, never in the disabled loop."""
    return straggler_stats(seconds)[0]


def straggler_stats(seconds: float) -> Tuple[float, int]:
    """(skew, slowest_rank) for one iteration over the same all_gather
    as :func:`straggler_skew`: the rank that took the longest lets the
    watchdog NAME the straggler at trip time (no collective can run in
    the watchdog thread — the group may be what hung — so this is
    sampled on the telemetry path and read back from the
    ``coll.slowest_rank`` gauge)."""
    try:
        gathered = fleet_allgather([seconds])
        if gathered is None:
            return 0.0, 0
        times = gathered[:, 0]
        mean = float(times.mean())
        if mean <= 0.0:
            return 0.0, 0
        return (float((times.max() - times.min()) / mean),
                int(times.argmax()))
    except Exception:
        return 0.0, 0


def fleet_allgather(payload, _gather=None):
    """One all_gather of a small per-rank float32 vector — the single
    blocking host sync per iteration the telemetry plane is allowed.
    The fleet aggregator (obs/aggregate.py) widens the payload that
    ``straggler_stats`` gathers alone, so group-level metrics ride the
    skew barrier instead of adding a second one. It bypasses ``STATS``
    and ``collective_span``: the telemetry's own traffic is not the
    training's.

    Returns an (nranks, len(payload)) float64 numpy array, or None
    outside a group of more than one rank. ``_gather`` is injectable
    for tests: it receives the local float32 vector and returns the
    stacked per-rank payloads."""
    import numpy as np
    vec = np.asarray(payload, dtype=np.float32).ravel()
    if _gather is None:
        if not is_active():
            return None
        _gather = _fleet_gather
    out = np.asarray(_gather(vec), dtype=np.float64)
    return out.reshape(-1, vec.size)


def _fleet_gather(vec):
    """``all_gather_into_tensor`` of ``vec`` on the group's device."""
    dist = _dist()
    dev = comm_device()
    t = torch.as_tensor(vec, device=dev)
    out = torch.empty(dist.get_world_size() * t.numel(), dtype=t.dtype,
                      device=dev)
    dist.all_gather_into_tensor(out, t)
    return out.cpu().numpy()


def all_gather(x: torch.Tensor) -> torch.Tensor:
    """[D, *x.shape]: every rank's ``x``, in rank order, on every rank
    (``jax.lax.all_gather`` over the "data" axis)."""
    if not is_active():
        return x[None]
    with collective_span("all_gather", _nbytes(x)):
        return _gather(x)


def _gather(x: torch.Tensor) -> torch.Tensor:
    dist = _dist()
    d = dist.get_world_size()
    with _Span(x):
        src, staged = _staged(x.contiguous())
        flat = src.reshape(-1)
        if flat.dtype == torch.bool:
            flat = flat.to(torch.uint8)
        out = torch.empty(d * flat.numel(), dtype=flat.dtype,
                          device=flat.device)
        dist.all_gather_into_tensor(out, flat)
        out = out.view(d, *x.shape)
        if x.dtype == torch.bool:
            out = out.to(torch.bool)
        return out.to(x.device) if staged else out


def _all_reduce(x: torch.Tensor, op, name: str) -> torch.Tensor:
    dist = _dist()
    with collective_span(name, _nbytes(x)), _Span(x):
        src, staged = _staged(x.clone())
        dist.all_reduce(src, op=op)
        return src.to(x.device) if staged else src


def psum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the ranks (``jax.lax.psum``). Floats: the all-gathered
    values summed in rank order onto +0.0; integers: one exact
    ``all_reduce``."""
    if not is_active():
        return x
    if x.is_floating_point():
        with collective_span("psum", _nbytes(x)):
            g = _gather(x)
        out = g[0] + 0.0
        for r in range(1, g.shape[0]):
            out = out + g[r]
        return out
    if x.dtype == torch.bool:
        x = x.to(torch.int32)
    return _all_reduce(x, _dist().ReduceOp.SUM, "psum")


def pmax(x: torch.Tensor) -> torch.Tensor:
    """Maximum over the ranks (``jax.lax.pmax``)."""
    if not is_active():
        return x
    return _all_reduce(x, _dist().ReduceOp.MAX, "pmax")


# -- process wiring ----------------------------------------------------
def parse_machine_list(machines: str) -> List[str]:
    """'ip1:port1,ip2:port2' -> ['ip1:port1', ...] (reference
    Config::machines / machine_list_filename format). Every entry is
    validated up front: a malformed entry fails here, naming itself."""
    out = []
    for part in str(machines).replace("\n", ",").split(","):
        part = part.strip()
        if part:
            _validate_machine_entry(part, len(out))
            out.append(part)
    return out


def _validate_machine_entry(entry: str, index: int) -> None:
    """One machine-list entry must be host:port with a non-empty host
    and a port in 1..65535 (log.fatal otherwise, naming the entry)."""
    host, sep, port = entry.rpartition(":")
    if not sep or not host:
        log.fatal("machines entry %d (%r) is not host:port — every "
                  "entry needs an explicit port (reference "
                  "Config::machines format)", index, entry)
    try:
        port_num = int(port)
    except ValueError:
        port_num = -1
    if not 1 <= port_num <= 65535:
        log.fatal("machines entry %d (%r) has invalid port %r — "
                  "expected an integer in 1..65535", index, entry, port)


def local_addresses() -> List[str]:
    """Addresses that identify this host (hostname, resolved IPs,
    loopback): the rank-discovery probe set."""
    addrs = {"127.0.0.1", "localhost"}
    try:
        host = socket.gethostname()
        addrs.add(host)
        try:
            addrs.update(info[4][0] for info in socket.getaddrinfo(
                host, None, family=socket.AF_INET))
        except socket.gaierror:
            pass
        # the address used for outward traffic (a UDP connect sends no
        # packet)
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        try:
            s.connect(("10.255.255.255", 1))
            addrs.add(s.getsockname()[0])
        except OSError:
            pass
        finally:
            s.close()
    except OSError:
        pass
    return sorted(addrs)


def resolve_rank_all(machines: Sequence[str],
                     local: Optional[Sequence[str]] = None) -> List[int]:
    """Every machine-list index whose host part matches this host (more
    than one: several processes on this host, which the caller tells
    apart by an explicit rank)."""
    if local is None:
        local = local_addresses()
    local_set = set(local)
    return [r for r, entry in enumerate(machines)
            if entry.rsplit(":", 1)[0] in local_set]


def _classify_init_error(exc: BaseException, coordinator: str,
                         rank_: int, num_processes: int
                         ) -> Tuple[str, str]:
    """(kind, actionable hint) for one failed group initialization."""
    text = f"{type(exc).__name__}: {exc}".lower()
    if "timed out" in text or "timeout" in text or "deadline" in text:
        return ("timeout",
                f"the store at {coordinator} never assembled all "
                f"{num_processes} processes — a peer is down, still "
                "booting, or the machine list disagrees across hosts; "
                "check that every host runs the same list and raise "
                "time_out if peers boot slowly")
    if "refused" in text or "unavailable" in text or "unreachable" in text \
            or "no route" in text:
        return ("refused",
                f"nothing is listening at {coordinator} — rank 0 has not "
                "started (or a firewall drops the port); start rank 0 "
                "first or fix the address")
    if "rank" in text or "already" in text or "mismatch" in text:
        return ("rank mismatch",
                f"this process claimed rank {rank_} of {num_processes} "
                "but the group disagrees — two processes resolved the "
                "same rank (duplicate machine-list entry?) or "
                "num_machines differs across hosts")
    return ("unknown", "unrecognized bring-up failure; see the "
                       "underlying error above")


def _backend_for(device_type: Optional[str]) -> str:
    """NCCL for CUDA devices, gloo on the CPU."""
    if device_type != "cpu" and torch.cuda.is_available():
        return "nccl"
    return "gloo"


def _startup_health_barrier(timeout_s: float, _barrier=None) -> None:
    """Every process must reach this barrier within ``timeout_s``, or
    bring-up fails here (a peer can pass initialization and wedge
    before its first collective). The barrier runs in a daemon thread,
    so a hung group cannot hang bring-up past the deadline."""
    if _barrier is None:
        if not is_active():
            return
        # read here: a new thread's current CUDA device is cuda:0
        dev = comm_device()

        def _barrier():
            _dist().all_reduce(torch.ones(1, device=dev))

    failure: List[BaseException] = []
    done = threading.Event()

    def _run() -> None:
        try:
            _barrier()
        except BaseException as exc:  # surfaced below, not swallowed
            failure.append(exc)
        finally:
            done.set()

    t = threading.Thread(target=_run, name="lgbm-startup-barrier",
                         daemon=True)
    t.start()
    if not done.wait(timeout_s):
        log.fatal("startup health barrier timed out after %.0fs: the "
                  "process group initialized but its first collective "
                  "never completed — a peer process wedged after "
                  "initialization (check its logs)", timeout_s)
    if failure:
        log.fatal("startup health barrier failed: %s: %s",
                  type(failure[0]).__name__, failure[0])
    log.debug("startup health barrier passed (%d processes)", world_size())


def ensure_distributed(machines: str = "", num_machines: int = 1,
                       time_out: int = 120, device_type: Optional[str] = None,
                       _initialize=None, _sleep=None,
                       _barrier=None) -> bool:
    """Set up the default process group for a multi-process run.
    Returns True when a group is active after the call.

    - a default group the caller already initialized (``torchrun``, a
      test harness) is used as it is;
    - ``num_machines <= 1`` is a no-op;
    - with an empty machine list, ``MASTER_ADDR`` / ``RANK`` /
      ``WORLD_SIZE`` in the environment drive the group; without them a
      single process trains alone;
    - with a list: a TCP store at entry 0, the world size from the list,
      the rank from this host's addresses (or ``RANK`` /
      ``LGBM_TPU_RANK`` when several entries are this host; a list whose
      entries are all this host and no such variable is a single
      process).

    ``time_out`` is in minutes (the reference's unit). Initialization
    is retried ``LGBM_TPU_INIT_RETRIES`` times (default 3) with
    exponential backoff and jitter, then a health barrier proves every
    process reachable. ``_initialize`` / ``_sleep`` / ``_barrier`` are
    injectable for tests (defaults: ``init_process_group`` /
    ``time.sleep`` / a one-element all-reduce)."""
    dist = _dist()
    if dist.is_available() and dist.is_initialized():
        return True
    if num_machines <= 1:
        return False
    backend_name = _backend_for(device_type)
    if backend_name == "nccl" and os.environ.get("LOCAL_RANK") is not None:
        # rank r's card before the group binds one
        torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
    init = _initialize or dist.init_process_group
    timeout_s = int(time_out) * 60
    mlist = parse_machine_list(machines)
    if not mlist:
        if (os.environ.get("MASTER_ADDR") and os.environ.get("RANK")
                and os.environ.get("WORLD_SIZE")):
            init(backend=backend_name,
                 timeout=datetime.timedelta(seconds=timeout_s))
            _startup_health_barrier(float(timeout_s), _barrier=_barrier)
            return True
        return False
    if len(mlist) != num_machines:
        log.warning("machines lists %d entries but num_machines=%d; "
                    "using the list length", len(mlist), num_machines)
        num_machines = len(mlist)
    local = local_addresses()
    matches = resolve_rank_all(mlist, local)
    if not matches:
        log.fatal("This host's addresses %s match no entry of the "
                  "machine list %s (reference socket-linker rank "
                  "discovery)", local, mlist)
    env_rank = os.environ.get("RANK", os.environ.get("LGBM_TPU_RANK"))
    if len(matches) > 1:
        if env_rank is None:
            if len(matches) == len(mlist):
                log.info("All %d machine-list entries resolve locally and "
                         "no RANK is set: one process trains alone",
                         len(mlist))
                return False
            log.fatal("Machine list places %d processes on this host "
                      "(%s); set RANK (or LGBM_TPU_RANK) to pick this "
                      "process's entry — the list's ports are the peers' "
                      "listen ports and cannot tell local processes apart",
                      len(matches), matches)
        my_rank = int(env_rank)
        if my_rank not in matches:
            log.fatal("RANK=%d is not one of this host's machine-list "
                      "entries %s", my_rank, matches)
    else:
        my_rank = matches[0]
    sleep = _sleep or time.sleep
    try:
        attempts = max(1, int(os.environ.get(_INIT_RETRIES_ENV,
                                             _DEFAULT_INIT_RETRIES)))
    except ValueError:
        attempts = _DEFAULT_INIT_RETRIES
    # rank-seeded jitter: peers back off by different amounts
    jitter_rng = random.Random(my_rank)
    last: Optional[BaseException] = None
    for attempt in range(attempts):
        try:
            init(backend=backend_name, init_method=f"tcp://{mlist[0]}",
                 world_size=num_machines, rank=my_rank,
                 timeout=datetime.timedelta(seconds=timeout_s))
            last = None
            break
        except Exception as exc:
            last = exc
            kind, hint = _classify_init_error(exc, mlist[0], my_rank,
                                              num_machines)
            if kind == "rank mismatch":
                log.fatal("process group bring-up failed (rank "
                          "mismatch): %s: %s — %s",
                          type(exc).__name__, exc, hint)
            if attempt + 1 >= attempts:
                break
            delay = min(_BACKOFF_CAP_S, _BACKOFF_BASE_S * (2 ** attempt))
            delay *= 1.0 + 0.25 * jitter_rng.random()
            log.warning("process group initialization attempt %d/%d "
                        "failed (%s): %s — retrying in %.1fs",
                        attempt + 1, attempts, kind, exc, delay)
            sleep(delay)
    if last is not None:
        kind, hint = _classify_init_error(last, mlist[0], my_rank,
                                          num_machines)
        log.fatal("process group bring-up failed after %d attempts "
                  "(%s): %s: %s — %s", attempts, kind,
                  type(last).__name__, last, hint)
    log.info("torch.distributed initialized: rank %d/%d, store %s, "
             "backend %s", my_rank, num_machines, mlist[0], backend_name)
    _startup_health_barrier(float(timeout_s), _barrier=_barrier)
    return True
