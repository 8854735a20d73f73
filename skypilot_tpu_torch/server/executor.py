"""Request executor: LONG vs SHORT pools (parity:
sky/server/requests/executor.py:1-20 design note).

LONG requests (launch/provision/down — minutes, hold cluster locks) run
each in their OWN worker process (reference: per-request processes,
sky/server/requests/process.py:16): a hung provision can be killed via
`POST /requests/{id}/cancel` without poisoning a pool, and worker death
releases its OS file locks.  A bounded thread pool launches/joins the
processes, so LONG concurrency stays capped and excess requests queue.

SHORT requests (status/queue/cancel — sub-second) stay on a thread pool;
they are not cancellable (nothing to kill that won't finish first).

Results/errors persist to the requests DB; the HTTP layer returns request
ids immediately.
"""
from __future__ import annotations

import concurrent.futures
import multiprocessing
import threading
import time
import traceback
from typing import Any, Callable, Dict, Optional

from skypilot_tpu_torch import sky_logging
from skypilot_tpu_torch.server import metrics
from skypilot_tpu_torch.server import requests_db
from skypilot_tpu_torch.server.requests_db import RequestStatus

logger = sky_logging.init_logger(__name__)

_LONG_WORKERS = 4
_SHORT_WORKERS = 16

# 'spawn', not 'fork': the server is a threaded process (event loop +
# consolidated controllers), and a forked child would inherit open sqlite
# connections and possibly mid-acquire locks.  Spawn costs ~2s of
# interpreter startup per request — noise against minutes-long
# provisions, and the child starts from a clean slate.
_MP_CTX = multiprocessing.get_context('spawn')


class _AdoptedWorker:
    """Process-like wrapper over a bare pid: a worker spawned by a
    previous server incarnation that is still running.  Lets cancel/
    drain/shutdown manage re-adopted workers exactly like fresh ones."""

    def __init__(self, pid: int) -> None:
        self.pid = pid
        self.exitcode: Optional[int] = None

    def is_alive(self) -> bool:
        import os
        try:
            os.kill(self.pid, 0)
            return True
        except (ProcessLookupError, PermissionError):
            return False

    def terminate(self) -> None:
        import os
        import signal
        try:
            os.kill(self.pid, signal.SIGTERM)
        except ProcessLookupError:
            pass

    def kill(self) -> None:
        import os
        import signal
        try:
            os.kill(self.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass

    def join(self, timeout: Optional[float] = None) -> None:
        deadline = None if timeout is None else time.time() + timeout
        while self.is_alive():
            if deadline is not None and time.time() > deadline:
                return
            time.sleep(0.2)
        self.exitcode = 0   # unknowable for a non-child; treat as clean


def _pid_started_before(pid: int, created_at: float) -> bool:
    """True if `pid` started BEFORE the request existed — i.e. the pid
    was recycled to an unrelated process (e.g. after a host reboot) and
    cannot be our worker.  Linux /proc; unknown -> False (assume ours)."""
    try:
        with open(f'/proc/{pid}/stat', 'r') as f:
            fields = f.read().rsplit(')', 1)[1].split()
        start_ticks = int(fields[19])                  # starttime
        with open('/proc/uptime', 'r') as f:
            uptime = float(f.read().split()[0])
        hz = 100.0
        import os
        try:
            hz = float(os.sysconf('SC_CLK_TCK'))
        except (ValueError, OSError):
            pass
        started_at = time.time() - uptime + start_ticks / hz
        return started_at < created_at - 5.0           # 5s clock slack
    except (OSError, IndexError, ValueError):
        return False


class RequestExecutor:
    def __init__(self) -> None:
        self._long = concurrent.futures.ThreadPoolExecutor(
            _LONG_WORKERS, thread_name_prefix='skytpu-long')
        self._short = concurrent.futures.ThreadPoolExecutor(
            _SHORT_WORKERS, thread_name_prefix='skytpu-short')
        self._procs: Dict[str, Any] = {}
        # Dispatched-but-unfinished LONG request ids (incl. those still
        # queued for a pool slot) — what drain() must wait out.
        self._active: set = set()
        self._lock = threading.Lock()
        self._recovery_stop = threading.Event()
        self._recovery_thread: Optional[threading.Thread] = None

    # ----- LONG: per-request worker process ----------------------------------
    def submit_process(self, name: str, body: Dict[str, Any]) -> str:
        """Run a named handler (server/handlers.py) in its own process."""
        import os
        from skypilot_tpu_torch.server import handlers
        assert name in handlers.HANDLERS, name
        request_id = requests_db.create(name, body, 'long')
        # Claim before dispatch: a sibling worker's concurrent startup
        # recovery must not also dispatch this fresh PENDING row.  If
        # the sibling's recovery won the CAS first, IT dispatches — a
        # second dispatch here would run the handler twice.
        if requests_db.try_claim(request_id, os.getpid()):
            self._dispatch(request_id, name, body)
        return request_id

    def _dispatch(self, request_id: str, name: str,
                  body: Dict[str, Any]) -> None:
        """Supervise one already-persisted request in a worker process
        (shared by fresh submissions and startup re-adoption of queued
        rows — the requests DB is the durable queue)."""
        from skypilot_tpu_torch.server import handlers
        with self._lock:
            self._active.add(request_id)

        def supervise():
            rec = requests_db.get(request_id)
            if rec is not None and rec['status'] is RequestStatus.CANCELLED:
                with self._lock:
                    self._active.discard(request_id)
                return   # cancelled while queued
            proc = _MP_CTX.Process(
                target=handlers.run_request,
                args=(request_id, name, body),
                name=f'skytpu-req-{request_id}', daemon=False)
            with self._lock:
                self._procs[request_id] = proc
            t0 = time.perf_counter()
            metrics.add_gauge('skytpu_requests_in_flight', 1, kind='long')
            proc.start()
            # Close the cancel race: a cancel landing between the queued
            # check above and start() found no live process to kill —
            # re-check now that the process is registered and running.
            rec2 = requests_db.get(request_id)
            if rec2 is not None and \
                    rec2['status'] is RequestStatus.CANCELLED:
                proc.terminate()
            try:
                proc.join()
                if proc.exitcode not in (0, None):
                    # Killed (cancel) or crashed before writing a result;
                    # the guarded UPDATE is a no-op if a status landed.
                    requests_db.set_status(
                        request_id, RequestStatus.FAILED,
                        error=f'worker exited with code {proc.exitcode}')
            finally:
                with self._lock:
                    self._procs.pop(request_id, None)
                    self._active.discard(request_id)
                metrics.add_gauge('skytpu_requests_in_flight', -1,
                                  kind='long')
                final = requests_db.get(request_id)
                status = (final['status'].value if final else 'UNKNOWN')
                metrics.inc_counter('skytpu_requests_total', name=name,
                                    status=status)
                metrics.observe('skytpu_request_duration_seconds',
                                time.perf_counter() - t0, name=name)

        self._long.submit(supervise)

    def recover(self) -> None:
        """Re-adopt the persisted request queue after a server restart
        (parity: queue-transport semantics, sky/server/requests/queues —
        here the requests DB is the sqlite-backed transport):

        - RUNNING rows whose worker pid is gone died with the old server
          -> FAILED (the workload may have half-happened; the cluster
          record stays reattachable, so a retry is safe);
        - PENDING rows for process handlers were queued but never
          started -> dispatch them now;
        - PENDING rows for thread work (closures died with the process)
          -> FAILED; their subsystems (jobs/serve controllers) have
          their own re-adoption paths.
        """
        import os
        from skypilot_tpu_torch.server import handlers
        from skypilot_tpu_torch.state import leases
        me = os.getpid()
        lease_mode = leases.lease_mode(requests_db.db_dsn())
        # One liveness verdict per claimer per scan: the periodic pump
        # re-runs this against a possibly-remote DB, and N rows claimed
        # by the same sibling need one heartbeat lookup, not N.
        live_memo: Dict[str, bool] = {}

        def _inst_live(inst: str, claim_at) -> bool:
            if inst not in live_memo:
                live_memo[inst] = requests_db.claim_is_live(
                    None, claim_at, inst)
            return live_memo[inst]

        for rec in requests_db.nonterminal_requests():
            rid = rec['request_id']
            # Rows THIS executor is already driving are not recovery's
            # business.  The periodic lease-recovery pump re-runs this
            # scan while our own dispatches are mid-flight: a claimed
            # row sits PENDING until its worker stamps RUNNING, and
            # re-claiming our own row here would dispatch it twice
            # (and re-adopting an already-supervised worker would pile
            # a supervisor onto the LONG pool every tick).
            with self._lock:
                ours = rid in self._active or rid in self._procs
            if ours:
                continue
            claim_inst = rec.get('claim_instance')
            if lease_mode and claim_inst is not None and \
                    claim_inst == leases.instance_id():
                # Claimed by our own instance but not in self._active:
                # only possible for thread-work whose closure already
                # finished the bookkeeping race — never steal or fail
                # our own live claims; the owning thread writes the
                # terminal status.
                continue
            # A row claimed by a LIVE sibling server process is that
            # sibling's business — RUNNING thread work (pid NULL) and
            # its queued short requests would otherwise be marked
            # FAILED here while the sibling is actively executing them
            # (multi-worker: late-booting/respawned workers run this
            # scan while siblings serve).
            if lease_mode and claim_inst is not None:
                # Multi-node: ownership is the INSTANCE lease — pids
                # collide across hosts, so never compare them here.
                sibling = (claim_inst != leases.instance_id() and
                           _inst_live(claim_inst, rec['claim_at']))
            else:
                sibling = bool(
                    rec['claim_pid'] and rec['claim_pid'] != me and
                    requests_db.claim_is_live(rec['claim_pid'],
                                              rec['claim_at']))
            if sibling:
                continue          # the sibling supervises its own work
            if rec['status'] is RequestStatus.RUNNING:
                pid = rec['pid']
                # Multi-node: a worker pid recorded by an instance on
                # ANOTHER host is uncheckable (and unadoptable) here —
                # its lease is dead (the sibling check above), so the
                # node is gone and the worker with it.
                foreign = (lease_mode and claim_inst is not None and
                           not leases.same_host(claim_inst))
                alive = False
                if pid and not foreign:
                    try:
                        os.kill(pid, 0)
                        alive = True
                    except (ProcessLookupError, PermissionError):
                        alive = False
                # Guard against pid recycling (e.g. host reboot): a
                # process older than the request cannot be its worker.
                if alive and _pid_started_before(pid, rec['created_at']):
                    alive = False
                if not alive:
                    requests_db.set_status(
                        rid, RequestStatus.FAILED,
                        error='server restarted while request was '
                              'running; worker is gone')
                else:
                    # The old server's worker survived the restart:
                    # adopt it so cancel/drain/shutdown can manage it,
                    # and mark the row terminal if it dies without
                    # recording a result.
                    logger.info(f'adopting live worker pid={pid} for '
                                f'request {rid}')
                    self._adopt(rid, pid)
                continue
            # PENDING
            if rec['name'] in handlers.HANDLERS:
                # Multi-worker: N servers run recovery concurrently over
                # the shared DB — the claim CAS picks exactly one
                # dispatcher per row (and skips rows a live sibling
                # already owns).
                if not requests_db.try_claim(rid, os.getpid()):
                    continue
                logger.info(f're-adopting queued request {rid} '
                            f'({rec["name"]})')
                self._dispatch(rid, rec['name'], rec['body'])
            else:
                # Thread-work closure died with its server process (and
                # no live sibling owns the row).
                requests_db.set_status(
                    rid, RequestStatus.FAILED,
                    error='server restarted before this request started; '
                          'resubmit it')

    def start_periodic_recovery(self, interval_s: float) -> None:
        """Re-run recover() on a timer — the lease-takeover pump.

        Startup recovery alone cannot take over a sibling replica's
        rows: when the sibling dies, nobody restarts (the survivors are
        already up), and a lease looks live until one TTL after the
        last heartbeat.  A periodic rescan is what turns 'stealable' in
        to 'stolen'.  recover() is CAS-guarded end to end, so N
        replicas pumping concurrently still dispatch each row once.
        """
        if self._recovery_thread is not None and \
                self._recovery_thread.is_alive():
            return

        def loop():
            while not self._recovery_stop.wait(interval_s):
                try:
                    self.recover()
                except Exception:  # pylint: disable=broad-except
                    logger.exception('periodic lease recovery failed')

        self._recovery_thread = threading.Thread(
            target=loop, name='skytpu-lease-recovery', daemon=True)
        self._recovery_thread.start()

    def _adopt(self, request_id: str, pid: int) -> None:
        """Supervise a worker inherited from a previous server run."""
        worker = _AdoptedWorker(pid)
        with self._lock:
            self._procs[request_id] = worker
            self._active.add(request_id)

        def supervise():
            try:
                worker.join()
                # Worker wrote its own terminal status on success; if it
                # died without one, the guarded UPDATE below lands.
                requests_db.set_status(
                    request_id, RequestStatus.FAILED,
                    error='adopted worker exited without recording a '
                          'result')
            finally:
                with self._lock:
                    self._procs.pop(request_id, None)
                    self._active.discard(request_id)

        self._long.submit(supervise)

    def drain(self, timeout_s: float = 300.0) -> bool:
        """Graceful shutdown step 2 (after the app stops accepting
        mutations): wait out every dispatched LONG request — running
        worker processes AND requests still queued for a pool slot.
        Returns True if everything drained within the timeout."""
        deadline = time.time() + timeout_s
        while time.time() < deadline:
            with self._lock:
                busy = bool(self._active)
            if not busy:
                return True
            time.sleep(0.25)
        return False

    def cancel(self, request_id: str) -> bool:
        """Cancel a queued or in-flight LONG request.  Returns True if
        the request was cancelled (or already terminal -> False)."""
        rec = requests_db.get(request_id)
        if rec is None or rec['status'].is_terminal():
            return False
        # Mark first (sticky terminal), then kill any live worker.
        requests_db.set_status(request_id, RequestStatus.CANCELLED,
                               error='cancelled by user')
        with self._lock:
            proc = self._procs.get(request_id)
        if proc is not None and proc.is_alive():
            proc.terminate()
            proc.join(timeout=5)
            if proc.is_alive():
                proc.kill()
        return True

    # ----- SHORT (and consolidated controllers): thread pool -----------------
    def submit(self, name: str, body: Dict[str, Any],
               fn: Callable[[], Any], long: bool = True) -> str:
        import os
        # Born-claimed (single INSERT): a sibling worker's recovery must
        # never observe this thread-work row unclaimed — it cannot see
        # our thread and would mark it FAILED ('server restarted') while
        # we still execute it.
        request_id = requests_db.create(name, body,
                                        'long' if long else 'short',
                                        claim_pid=os.getpid())
        pool = self._long if long else self._short

        def work():
            requests_db.set_status(request_id, RequestStatus.RUNNING)
            t0 = time.perf_counter()
            kind = 'long' if long else 'short'
            metrics.add_gauge('skytpu_requests_in_flight', 1, kind=kind)
            status = 'SUCCEEDED'
            try:
                result = fn()
                requests_db.set_status(request_id, RequestStatus.SUCCEEDED,
                                       result=result)
            except Exception as e:  # pylint: disable=broad-except
                status = 'FAILED'
                logger.warning(f'request {name}/{request_id} failed: {e}')
                requests_db.set_status(
                    request_id, RequestStatus.FAILED,
                    error=f'{type(e).__name__}: {e}\n'
                          f'{traceback.format_exc()}')
            finally:
                metrics.add_gauge('skytpu_requests_in_flight', -1,
                                  kind=kind)
                metrics.inc_counter('skytpu_requests_total', name=name,
                                    status=status)
                metrics.observe('skytpu_request_duration_seconds',
                                time.perf_counter() - t0, name=name)

        pool.submit(work)
        return request_id

    def shutdown(self) -> None:
        self._recovery_stop.set()
        if self._recovery_thread is not None:
            self._recovery_thread.join(timeout=2.0)
        with self._lock:
            procs = list(self._procs.values())
        for proc in procs:
            if proc.is_alive():
                proc.terminate()
        self._long.shutdown(wait=False, cancel_futures=True)
        self._short.shutdown(wait=False, cancel_futures=True)
