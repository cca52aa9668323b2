"""Inter-process exchange fabric for the multi-process worker cluster.

The port of ``pathway_tpu/parallel/comm.py`` (the reference's
timely-dataflow communication layer, external/timely-dataflow/
communication/: a localhost or remote TCP mesh between worker processes
carrying typed serialized channels plus progress gossip).  Here the fabric
carries three message families over one full TCP mesh:

  - data(time, pos, port, shard, seq, updates) — update batches crossing a
    process boundary at an exchange edge (the reference's exchange channels)
  - mark(time, pos, counts) — "this process finished every topo position
    < pos at `time`; here is, per destination, the cumulative number of
    data frames I have stamped for every (time, p<=pos)".  The mark is not
    an ordering barrier — it carries COUNTS, so a receiver count-proves
    completeness of a (time, pos) exchange point
    (received-per-(peer,time,pos) == announced) instead of relying on
    per-connection FIFO between the mark and the data.  That freedom is
    what lets bulk data frames ride an asynchronous sender thread while
    marks overtake them on a control lane: a quiet exchange point costs
    one tiny control frame, and the wait only blocks when frames are
    genuinely in flight.
  - ctl(payload) — worker->coordinator reports and coordinator broadcasts
    (advance/tick/endphase/rescale), the host control plane.  eot frames
    remain only for the shutdown barrier.

Send path: `send_data` only enqueues — pickling and socket writes happen
on one sender thread per peer, so serialization never sits on the compute
thread.  Each sender drains two lanes: a control lane (ctl/marks/eot;
marks for the same logical time coalesce to the newest) that is flushed
before the data lane each cycle, and a FIFO data lane whose small frames
coalesce per (time, pos) into one grouped frame (one pickle, one write, N
logical frames — the receiver unpacks and counts each).  Queues are
bounded; a full queue blocks the producer (billed to ``send_s``, so
backpressure stays visible in the wall split).

Host values on the wire: a row may carry a torch tensor on the card (an
embedding) or a ``DeviceVec`` handle.  Plain pickling would copy a CUDA
tensor to the host inside the sender thread and rebuild it on the
receiver's card, a sync nobody asked for and a CUDA context in a process
that may not want one.  The sender's pickler writes every device tensor
as its host copy instead (a ``DeviceVec`` already pickles as its numpy
row), counts each such copy in ``stats["host_copies"]``, and the receiver
gets host values; its data plane moves them to its device when an
operator needs them there.

Progress/EOT: a cross-time or out-of-walk send is "vouched" by its sender
— its target logical time joins the sender's min-agreement report — until
the sender has itself processed that time (the agreed walk guarantees
every process ran it, and the receiver's counted mark-wait there proved
delivery).  Same-time sends during the walk are covered by the counted
marks alone.

Addresses: process i listens on first_port + i on localhost (multi-host
would swap the address table, as the reference's PATHWAY_ADDRESSES does).
Connection protocol: i dials every j < i; accepts from every j > i.
Peers authenticate with an HMAC over ``PATHWAY_FABRIC_SECRET`` (the
``spawn`` supervisor sets one per run) before any pickled frame is read.
"""

from __future__ import annotations

import hmac
import io
import logging
import os
import pickle
import queue
import socket
import struct
import threading
import time as _time
from collections import defaultdict, deque
from typing import Any

import torch

from .. import faults, obs
from ..internals.value import Pointer

_LEN = struct.Struct("<I")

# Per-run shared secret for peer authentication (the spawner generates one
# and passes it via env).  The fabric unpickles frames from its peers; on a
# multi-user host an unauthenticated listener would hand arbitrary-code
# pickle execution to any local process that can dial the port.
_SECRET_ENV = "PATHWAY_FABRIC_SECRET"

# Fault injection for tests (see tests/test_overlap_fabric.py): delay every
# sender-thread drain cycle by N ms, optionally only on one pid.  Forces
# queue buildup (=> coalescing) and models a delayed straggler without
# touching protocol code paths.
_DELAY_ENV = "PW_FABRIC_SEND_DELAY_MS"
_DELAY_PID_ENV = "PW_FABRIC_DELAY_PID"

# sender-queue bound: frames (not bytes) per peer; a full queue blocks the
# producer so memory stays bounded under a slow peer
_MAX_QUEUED_FRAMES = 8192

# data frames drained per sender cycle: bounds how long one encode+write
# window can starve the ctl lane (heartbeats) — see _PeerSender.run
_MAX_DRAIN_FRAMES = 1024

# liveness knobs: heartbeats ride the ctl lane every
# PW_FABRIC_HEARTBEAT_S (0 disables); a peer silent for longer than
# PW_FABRIC_PEER_TIMEOUT_S while this process is blocked on it raises a
# typed PeerLostError; PW_FABRIC_WAIT_TIMEOUT_S bounds EVERY blocking
# protocol recv (mark/eot/ctl) so a lost-but-undiagnosed frame (a chaos
# `drop`, a half-open connection) can never hang the mesh forever.
_HB_ENV = "PW_FABRIC_HEARTBEAT_S"
_PEER_TIMEOUT_ENV = "PW_FABRIC_PEER_TIMEOUT_S"
_WAIT_TIMEOUT_ENV = "PW_FABRIC_WAIT_TIMEOUT_S"


class _HostPickler(pickle.Pickler):
    """Pickles a frame with every device tensor as its host copy (see the
    module docstring), counting the copies; ``DeviceVec`` handles count
    too (their own ``__reduce__`` carries the host row)."""

    def __init__(self, buf) -> None:
        super().__init__(buf, protocol=pickle.HIGHEST_PROTOCOL)
        self.host_copies = 0

    def reducer_override(self, obj):
        if type(obj) is Pointer:
            return NotImplemented  # every row key: the common case first
        if isinstance(obj, torch.Tensor):
            if obj.device.type == "cpu":
                return NotImplemented
            self.host_copies += 1
            return obj.detach().to("cpu").__reduce_ex__(
                pickle.HIGHEST_PROTOCOL)
        if type(obj).__name__ == "DeviceVec":
            self.host_copies += 1
        return NotImplemented


def _dumps(obj) -> tuple[bytes, int]:
    """``(pickled bytes, device values copied to the host)``."""
    buf = io.BytesIO()
    pickler = _HostPickler(buf)
    pickler.dump(obj)
    return buf.getvalue(), pickler.host_copies


def _fabric_secret() -> bytes | None:
    s = os.environ.get(_SECRET_ENV)
    return s.encode() if s else None


class FabricError(RuntimeError):
    pass


class PeerLostError(FabricError):
    """A peer process is gone (disconnected, silent past the heartbeat
    deadline, or its exchange frames never arrived) while this process
    was blocked on it.  Typed so supervisors and tests can tell a
    liveness failure from a protocol bug, and carries WHAT the caller
    was blocked on so the abort point is attributable."""

    def __init__(self, peer: int, waiting_on: str, detail: str = ""):
        self.peer = peer
        self.waiting_on = waiting_on
        msg = f"peer {peer} lost while waiting on {waiting_on}"
        if detail:
            msg += f": {detail}"
        super().__init__(msg)


class ClusterAborted(FabricError):
    """A peer broadcast a poison frame: it hit a failure and the whole
    mesh is aborting at a consistent point.  Survivors raise this from
    every blocking fabric call instead of timing out one by one."""

    def __init__(self, reason: str):
        self.reason = reason
        super().__init__(f"cluster aborted by a peer: {reason}")


class _FaultClose(Exception):
    """Internal: a chaos `close` action severed this sender's socket."""


class _PeerSender(threading.Thread):
    """Asynchronous send path for one peer: the compute thread enqueues,
    this thread pickles + writes.  Two lanes:

      - ctl lane: ctl payloads / counted marks / eot.  Flushed before the
        data lane each drain cycle so progress control overtakes bulk data
        (safe: marks carry counts, so ordering vs data is irrelevant).
        Marks for the same logical time coalesce to the newest (cursor and
        counts are both monotone).
      - data lane: strict FIFO.  Consecutive frames for the same
        (time, pos) coalesce into one grouped "D" frame carrying N logical
        frames (one pickle / one write); the receiver unpacks and counts
        every logical frame, so the counted-delivery math is unchanged.
    """

    def __init__(self, fabric: "Fabric", peer: int, sock: socket.socket):
        super().__init__(daemon=True, name=f"pw-fabric-send-{peer}")
        self.fabric = fabric
        self.peer = peer
        self.sock = sock
        self.ctl: deque = deque()
        self.data: deque = deque()
        self.cond = threading.Condition()
        self.idle = True  # False while a popped batch is being written
        self.stopped = False
        delay = float(os.environ.get(_DELAY_ENV, "0") or 0)
        dpid = os.environ.get(_DELAY_PID_ENV)
        if dpid is not None and dpid != "" and int(dpid) != fabric.pid:
            delay = 0.0
        self.delay_s = delay / 1000.0

    # -- producer side (compute thread) -----------------------------------
    def put_data(self, item: tuple) -> None:
        with self.cond:
            while (
                len(self.data) >= _MAX_QUEUED_FRAMES
                and not self.stopped
                and self.fabric._dead is None
                and self.fabric._poisoned is None
            ):
                self.cond.wait(timeout=0.5)
            self.fabric._check()
            self.data.append(item)
            self._note_depth()
            self.cond.notify_all()

    def put_ctl(self, item: tuple) -> None:
        with self.cond:
            self.fabric._check()
            if item[0] == "h" and any(old[0] == "h" for old in self.ctl):
                return  # one pending heartbeat is as good as many
            if item[0] == "M":
                # coalesce: one pending mark per logical time — the newest
                # cursor/counts supersede (both monotone per time)
                t = item[1]
                for i, old in enumerate(self.ctl):
                    if old[0] == "M" and old[1] == t:
                        self.ctl[i] = item
                        self.fabric._bump("sender_mark_coalesced", 1)
                        self.cond.notify_all()
                        return
            self.ctl.append(item)
            self._note_depth()
            self.cond.notify_all()

    def _note_depth(self) -> None:
        # one scope for both gauges: the cross-peer TOTAL of queued
        # frames (a per-peer peak under a global depth reads nonsense)
        total = self._total_depth()
        st = self.fabric.stats
        st["sender_queue_depth"] = total
        if total > st["sender_queue_peak"]:
            st["sender_queue_peak"] = total

    def _total_depth(self) -> int:
        return sum(
            len(s.data) + len(s.ctl) for s in self.fabric._senders.values()
        )

    def flush(self, timeout_s: float = 120.0) -> None:
        deadline = _time.monotonic() + timeout_s
        with self.cond:
            while self.ctl or self.data or not self.idle:
                if self.stopped or self.fabric._dead is not None:
                    return
                if not self.cond.wait(timeout=0.2):
                    if _time.monotonic() > deadline:
                        raise FabricError(
                            f"pid {self.fabric.pid}: sender flush timeout "
                            f"to peer {self.peer}"
                        )

    def stop(self) -> None:
        with self.cond:
            self.stopped = True
            self.cond.notify_all()

    # -- consumer side (sender thread) ------------------------------------
    def run(self) -> None:
        try:
            while True:
                with self.cond:
                    while not self.ctl and not self.data and not self.stopped:
                        self.cond.wait(timeout=0.5)
                    if self.stopped and not self.ctl and not self.data:
                        return
                    ctl_batch = list(self.ctl)
                    self.ctl.clear()
                    # cap the data drained per cycle — a
                    # near-full queue encoded as ONE payload would write
                    # nothing (heartbeats included) for the whole pickle
                    # window, tripping peers' liveness deadlines on a
                    # healthy loaded mesh.  Leftovers stay queued (FIFO);
                    # idle stays False so flush() still waits them out.
                    data_batch = [
                        self.data.popleft()
                        for _ in range(min(len(self.data),
                                           _MAX_DRAIN_FRAMES))
                    ]
                    self.idle = False
                    self.fabric.stats["sender_queue_depth"] = (
                        self._total_depth()
                    )
                    self.cond.notify_all()
                if self.delay_s:
                    _time.sleep(self.delay_s)
                # chaos harness (faults.py): when any fault is armed,
                # every logical frame passes a fabric.send.{ctl,data}
                # fault point (delay/drop/close).  Checked per CYCLE —
                # cheap enough off the compute thread, and late
                # faults.install() calls are honored
                if faults.active():
                    ctl_batch, data_batch = self._apply_chaos(
                        ctl_batch, data_batch
                    )
                t0 = _time.perf_counter()
                # ctl lane written FIRST as its own payload: heartbeats
                # and marks hit the wire before this cycle's (possibly
                # large) data encode+write, keeping liveness signals
                # flowing while bulk frames serialize
                ctl_frames = [_dumps(it)[0] for it in ctl_batch]
                ctl_payload = b"".join(
                    _LEN.pack(len(b)) + b for b in ctl_frames
                )
                if ctl_payload:
                    self.sock.sendall(ctl_payload)
                frames = self._coalesce(data_batch)
                payload = b"".join(
                    _LEN.pack(len(b)) + b for b in frames
                )
                if payload:
                    self.sock.sendall(payload)
                st = self.fabric.stats
                with self.fabric._cond:
                    st["sender_s"] += _time.perf_counter() - t0
                    st["sender_flushes"] += 1
                    st["send_count"] += len(ctl_frames) + len(frames)
                    st["send_bytes"] += len(ctl_payload) + len(payload)
                with self.cond:
                    self.idle = True
                    self.cond.notify_all()
        except _FaultClose:
            # chaos `close`: sever the connection abruptly, exactly like
            # a mid-run network partition — both directions die (the
            # peer sees EOF; our recv loop errors on the same socket)
            try:
                self.sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                self.sock.close()
            except OSError:
                pass
            self.fabric._sender_died(
                self.peer, ConnectionResetError("fault-injected close")
            )
        except Exception as exc:  # noqa: BLE001 — pickling moved off the
            # compute thread, so a serialization failure (unpicklable
            # update value) surfaces HERE now; it must kill the fabric
            # loudly like a socket error, not strand peers at mark waits
            self.fabric._sender_died(self.peer, exc)
        finally:
            with self.cond:
                self.idle = True
                self.stopped = True
                self.cond.notify_all()

    def _apply_chaos(self, ctl_batch: list, data_batch: list
                     ) -> tuple[list, list]:
        """Pass every logical frame through its fault point.  `drop`
        silently discards the frame (its announced count is never
        satisfied — the receiver's wait deadline converts that into a
        typed PeerLostError); `close` severs the socket; `delay` already
        slept inside fire()."""
        ctl_kept: list = []
        for it in ctl_batch:
            act = faults.fire("fabric.send.ctl", peer=self.peer, kind=it[0])
            if act == "drop":
                continue
            if act == "close":
                raise _FaultClose()
            ctl_kept.append(it)
        data_kept: list = []
        for it in data_batch:
            act = faults.fire("fabric.send.data", peer=self.peer,
                              time=it[1], pos=it[2])
            if act == "drop":
                continue
            if act == "close":
                raise _FaultClose()
            data_kept.append(it)
        return ctl_kept, data_kept

    def _coalesce(self, batch: list) -> list[bytes]:
        """Group consecutive data-lane items by (time, pos) into "D"
        frames.  FIFO is preserved (runs are consecutive); each logical
        frame stays individually counted on the receiver."""
        out: list[bytes] = []
        i, n = 0, len(batch)
        coalesced = 0
        host_copies = 0
        while i < n:
            _tag, t, pos, port, shard, seq, updates = batch[i]
            j = i + 1
            while j < n and batch[j][1] == t and batch[j][2] == pos:
                j += 1
            if j - i == 1:
                msg = ("d", t, pos, port, shard, self.fabric.pid, seq,
                       updates)
            else:
                entries = [
                    (b[5], b[3], b[4], b[6]) for b in batch[i:j]
                ]  # (seq, port, shard, updates)
                msg = ("D", t, pos, self.fabric.pid, entries)
                coalesced += (j - i) - 1
            blob, copies = _dumps(msg)
            out.append(blob)
            host_copies += copies
            i = j
        if coalesced or host_copies:
            with self.fabric._cond:
                self.fabric.stats["sender_coalesced"] += coalesced
                self.fabric.stats["host_copies"] += host_copies
        return out


class Fabric:
    def __init__(self, pid: int, nprocs: int, first_port: int,
                 host: str = "127.0.0.1", connect_timeout_s: float = 30.0):
        # PW_FABRIC_CONNECT_TIMEOUT_S overrides the mesh-formation
        # deadline (a short one makes a caller's retry on fresh ports
        # cheap when a loopback connect is refused)
        env_to = os.environ.get("PW_FABRIC_CONNECT_TIMEOUT_S")
        if env_to:
            connect_timeout_s = float(env_to)
        self.pid = pid
        self.n = nprocs
        self.peers = [p for p in range(nprocs) if p != pid]
        self._socks: dict[int, socket.socket] = {}
        self._cond = threading.Condition()
        # data[(time, pos)] -> list[(producer_pid, seq, port, shard, updates)]
        self._data: dict[tuple[int, int], list] = defaultdict(list)
        # marks[peer][time] -> highest pos the peer announced (its cursor)
        self._marks: dict[int, dict[int, int]] = defaultdict(dict)
        # announced[(peer, time)] -> {pos: cumulative frames the peer
        # stamped for us at (time, pos)} — merged max (counts are monotone)
        self._announced: dict[tuple[int, int], dict[int, int]] = {}
        # received[(peer, time, pos)] -> data frames landed (logical count)
        self._recv_pos_counts: dict[tuple[int, int, int], int] = defaultdict(int)
        # sent-by-time[time][dst][pos] -> cumulative logical frames stamped
        # (the mark snapshot source; pruned with the mark bookkeeping)
        self._sent_by_time: dict[int, dict[int, dict[int, int]]] = (
            defaultdict(lambda: defaultdict(lambda: defaultdict(int)))
        )
        # vouched sends: target times of out-of-walk sends this process
        # still answers for in the min-agreement (dropped once the target
        # time has itself been processed — see confirm_below)
        self._vouched: dict[int, int] = defaultdict(int)  # time -> n frames
        self._eot: set[tuple[int, int]] = set()  # (peer, time)
        self._done_peers: set[int] = set()  # peers past their shutdown barrier
        self._ctl: "queue.Queue[Any]" = queue.Queue()
        self._dead: str | None = None
        self._dead_peer: int | None = None  # which peer killed the fabric
        self._poisoned: str | None = None  # a peer's coordinated-abort reason
        self._closed = False
        # liveness: heartbeats on the ctl lane + a deadline on
        # every blocking recv.  _last_seen[peer] advances on ANY frame
        # from the peer; a peer silent past _peer_timeout_s while this
        # process is blocked on it raises PeerLostError instead of
        # hanging the mesh.
        self._hb_interval = float(os.environ.get(_HB_ENV, "2.0") or 0.0)
        self._peer_timeout_s = float(
            os.environ.get(_PEER_TIMEOUT_ENV, "15.0") or 0.0
        )
        wait_to = float(os.environ.get(_WAIT_TIMEOUT_ENV, "120") or 120.0)
        # 0 disables, like the sibling liveness knobs — an operator
        # opting out of the barrier deadline must not get an
        # instantly-expiring one
        self._wait_timeout_s = wait_to if wait_to > 0 else float("inf")
        self._last_seen: dict[int, float] = {
            p: _time.monotonic() for p in self.peers
        }
        # where exchange wall time goes: send_s is the COMPUTE thread's
        # enqueue cost
        # (including backpressure blocking); sender_s is the sender
        # thread's pickle+write time, overlapped with compute.
        self.stats = {
            "send_count": 0, "send_bytes": 0, "send_s": 0.0,
            "sender_s": 0.0, "sender_flushes": 0, "sender_coalesced": 0,
            "sender_mark_coalesced": 0, "host_copies": 0,
            "sender_queue_depth": 0, "sender_queue_peak": 0,
            "recv_count": 0, "recv_bytes": 0,
            "data_msgs_out": 0, "mark_msgs_out": 0, "ctl_msgs_out": 0,
            "wait_marks_s": 0.0, "wait_eot_s": 0.0, "wait_ctl_s": 0.0,
            "wait_data_s": 0.0,
            # wait_sync_s: shutdown/tick gather+broadcast rendezvous —
            # routed through the timed ctl path under its own stat so the
            # overlap work cannot hide stalls there
            "wait_sync_s": 0.0,
            # compute_s/agree_min_s filled by ClusterRunner;
            # wait_marks_s_p<N> splits the mark-barrier wait BY PEER so a
            # straggler is attributable to a process, not a guess
            "compute_s": 0.0, "agree_min_s": 0.0,
        }
        for p in self.peers:
            self.stats[f"wait_marks_s_p{p}"] = 0.0
        # data-plane trace: fabric wait spans for this process's rounds
        self._obs_ctx = (obs.new_trace_id(), 0)
        self._secret = _fabric_secret()
        if self._secret is None:
            logging.getLogger(__name__).warning(
                "%s not set: fabric peers are UNAUTHENTICATED; any local "
                "process can deliver pickle payloads to the worker mesh "
                "(the `spawn` supervisor sets the secret automatically)",
                _SECRET_ENV,
            )
        c0 = _time.perf_counter()
        self._connect(host, first_port, connect_timeout_s)
        # the mesh's formation: how long this process waited for its
        # peers, and when (wall clock, comparable across processes) the
        # mesh was whole
        self.stats["connect_s"] = _time.perf_counter() - c0
        self.formed_unix = _time.time()
        self._senders: dict[int, _PeerSender] = {}
        for peer, sock in self._socks.items():
            snd = _PeerSender(self, peer, sock)
            self._senders[peer] = snd
        self._threads = []
        for peer, sock in self._socks.items():
            th = threading.Thread(
                target=self._recv_loop, args=(peer, sock),
                daemon=True, name=f"pw-fabric-{peer}",
            )
            th.start()
            self._threads.append(th)
        for snd in self._senders.values():
            snd.start()
        self._hb_thread = None
        if self._hb_interval > 0 and self.peers:
            self._hb_thread = threading.Thread(
                target=self._heartbeat_loop, daemon=True,
                name="pw-fabric-hb",
            )
            self._hb_thread.start()

    def _heartbeat_loop(self) -> None:
        """Keep-alive on the ctl lane: proves this process is making
        progress even when it has no protocol traffic (a long compute
        stretch, an idle streaming worker), so peers blocked on us can
        tell 'slow' from 'dead'."""
        while True:
            _time.sleep(self._hb_interval)
            with self._cond:
                if (self._closed or self._dead is not None
                        or self._poisoned is not None):
                    return
            for snd in self._senders.values():
                try:
                    snd.put_ctl(("h",))
                except FabricError:
                    return

    def _bump(self, key: str, n: int) -> None:
        with self._cond:
            self.stats[key] += n

    # -- mesh formation ----------------------------------------------------
    def _connect(self, host: str, first_port: int, timeout_s: float) -> None:
        listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        deadline = _time.monotonic() + timeout_s
        while True:
            try:
                listener.bind((host, first_port + self.pid))
                break
            except OSError:
                if _time.monotonic() > deadline:
                    raise FabricError(
                        f"cannot bind fabric port {first_port + self.pid}"
                    )
                _time.sleep(0.2)
        listener.listen(self.n)
        accept_from = [p for p in self.peers if p > self.pid]
        dial_to = [p for p in self.peers if p < self.pid]
        accepted: dict[int, socket.socket] = {}

        def recv_exact(conn, n: int) -> bytes:
            out = b""
            while len(out) < n:
                chunk = conn.recv(n - len(out))
                if not chunk:
                    raise FabricError("peer hung up during handshake")
                out += chunk
            return out

        def handshake_accept(conn) -> int:
            """Returns the authenticated peer pid or raises FabricError."""
            hello = recv_exact(conn, 4)
            peer = int.from_bytes(hello, "little")
            if self._secret is not None:
                # mutual HMAC handshake: dialer proves knowledge of the
                # run secret before any pickle frame is accepted, and
                # the reply (bound to the dialer's nonce) proves ours
                nonce_d = recv_exact(conn, 16)
                tag_d = recv_exact(conn, 32)
                want = hmac.new(
                    self._secret, b"pw-dial" + hello + nonce_d, "sha256"
                ).digest()
                if not hmac.compare_digest(tag_d, want):
                    raise FabricError(
                        "fabric handshake rejected: bad peer credential"
                    )
                nonce_a = os.urandom(16)
                tag_a = hmac.new(
                    self._secret, b"pw-acpt" + nonce_d + nonce_a, "sha256"
                ).digest()
                conn.sendall(nonce_a + tag_a)
            return peer

        def do_accept():
            # a failed handshake (attacker / port scanner / crashed dialer)
            # must not consume a peer slot or kill the acceptor — close it
            # and keep listening for the real peers
            while len(accepted) < len(accept_from):
                conn, _addr = listener.accept()
                # handshake under its own timeout: an idle connection must
                # not stall the acceptor (that would be a trivial DoS)
                conn.settimeout(10.0)
                try:
                    peer = handshake_accept(conn)
                    conn.settimeout(None)
                except (FabricError, OSError) as exc:
                    logging.getLogger(__name__).warning(
                        "fabric: dropped unauthenticated connection: %s", exc
                    )
                    try:
                        conn.close()
                    except OSError:
                        pass
                    continue
                conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                accepted[peer] = conn

        acceptor = None
        if accept_from:
            listener.settimeout(timeout_s)
            acceptor = threading.Thread(target=do_accept, daemon=True)
            acceptor.start()
        def dial_once(peer: int) -> socket.socket:
            sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            sock.connect((host, first_port + peer))
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            pid_bytes = self.pid.to_bytes(4, "little")
            if self._secret is not None:
                nonce_d = os.urandom(16)
                tag_d = hmac.new(
                    self._secret, b"pw-dial" + pid_bytes + nonce_d, "sha256"
                ).digest()
                sock.settimeout(10.0)  # a silent listener must not hang us
                sock.sendall(pid_bytes + nonce_d + tag_d)
                reply = recv_exact(sock, 48)
                sock.settimeout(None)
                nonce_a, tag_a = reply[:16], reply[16:]
                want = hmac.new(
                    self._secret, b"pw-acpt" + nonce_d + nonce_a, "sha256"
                ).digest()
                if not hmac.compare_digest(tag_a, want):
                    raise FabricError(
                        "fabric handshake rejected: listener failed to "
                        "prove the run secret"
                    )
            else:
                sock.sendall(pid_bytes)
            return sock

        for peer in dial_to:
            # the WHOLE dial+handshake retries until the deadline: a
            # loopback can abort an established connection mid-handshake
            # (ECONNABORTED), which retrying only the connect() would not
            # survive.  A rejected credential is a real failure and is
            # never retried.
            while True:
                try:
                    self._socks[peer] = dial_once(peer)
                    break
                except FabricError as exc:
                    if "rejected" in str(exc):
                        raise
                    if _time.monotonic() > deadline:
                        raise FabricError(
                            f"cannot reach peer {peer}: {exc}"
                        )
                    _time.sleep(0.1)
                except OSError as exc:
                    if _time.monotonic() > deadline:
                        raise FabricError(
                            f"cannot reach peer {peer}: {exc}"
                        )
                    _time.sleep(0.1)
        if acceptor is not None:
            acceptor.join(timeout_s)
            if len(accepted) != len(accept_from):
                raise FabricError(
                    f"pid {self.pid}: only {len(accepted)}/{len(accept_from)} "
                    "peers connected"
                )
        self._socks.update(accepted)
        listener.close()

    # -- send --------------------------------------------------------------
    def _sender_died(self, peer: int, exc: Exception) -> None:
        with self._cond:
            if not self._closed and peer not in self._done_peers:
                self._dead = f"send path to peer {peer} failed: {exc!r}"
                self._dead_peer = peer
                self._ctl.put(("__peer_lost__", peer))
            self._cond.notify_all()
        for snd in self._senders.values():
            with snd.cond:
                snd.cond.notify_all()

    def send_data(self, peer: int, time: int, pos: int, port: int, shard: int,
                  seq: int, updates: list, vouch: bool = True) -> None:
        """Enqueue one data frame for the peer's sender thread.

        ``vouch=False`` marks a same-time send made inside the agreed walk
        of ``time``: its delivery is proven by the counted mark the sender
        posts when crossing (time, pos), so it never joins the
        min-agreement report.  Everything else (cross-time emissions,
        injections, on_end flushes) is vouched — its target time stays in
        this process's reported minimum until the time has been processed
        (``confirm_below``), which by the agreed walk implies every
        receiver count-proved the delivery."""
        t0 = _time.perf_counter()
        with self._cond:
            self._check_locked()
            self.stats["data_msgs_out"] += 1
            self._sent_by_time[time][peer][pos] += 1
            if vouch:
                self._vouched[time] += 1
        self._senders[peer].put_data(
            ("data", time, pos, port, shard, seq, updates)
        )
        with self._cond:
            self.stats["send_s"] += _time.perf_counter() - t0

    def post_mark(self, time: int, pos: int) -> None:
        """Counted mark: announce to every peer that this process finished
        all positions < pos at ``time``, together with the cumulative
        per-(destination, pos') frame counts it has stamped for ``time``.
        Receivers count-prove the exchange point instead of treating the
        frame as a FIFO barrier, so the mark rides the control lane and
        may legally overtake bulk data."""
        with self._cond:
            self._check_locked()
            self.stats["mark_msgs_out"] += 1
            by_dst = self._sent_by_time.get(time, {})
            counts = {dst: dict(per_pos) for dst, per_pos in by_dst.items()}
        msg = ("M", time, pos, counts)
        for peer in self.peers:
            self._senders[peer].put_ctl(msg)

    def send_eot(self, time: int) -> None:
        for peer in self.peers:
            self._senders[peer].put_ctl(("e", time))

    def send_ctl(self, peer: int, payload: Any) -> None:
        with self._cond:
            self._check_locked()
            self.stats["ctl_msgs_out"] += 1
        self._senders[peer].put_ctl(("c", payload))

    def broadcast_ctl(self, payload: Any) -> None:
        with self._cond:
            self._check_locked()
            self.stats["ctl_msgs_out"] += len(self.peers)
        for peer in self.peers:
            self._senders[peer].put_ctl(("c", payload))

    def flush(self, timeout_s: float = 120.0) -> None:
        """Block until every sender queue is drained and written."""
        for snd in self._senders.values():
            snd.flush(timeout_s)

    # -- receive -----------------------------------------------------------
    def _recv_loop(self, peer: int, sock: socket.socket) -> None:
        buf = b""

        def read_exact(n: int) -> bytes | None:
            nonlocal buf
            while len(buf) < n:
                try:
                    chunk = sock.recv(1 << 16)
                except OSError:
                    return None
                if not chunk:
                    return None
                buf += chunk
            out, buf = buf[:n], buf[n:]
            return out

        while True:
            header = read_exact(_LEN.size)
            if header is None:
                break
            blob = read_exact(_LEN.unpack(header)[0])
            if blob is None:
                break
            self.stats["recv_count"] += 1
            self.stats["recv_bytes"] += len(blob) + _LEN.size
            # any frame proves the peer is alive (GIL-atomic store)
            self._last_seen[peer] = _time.monotonic()
            msg = pickle.loads(blob)
            kind = msg[0]
            if kind == "d":
                _, t, pos, port, shard, producer, seq, updates = msg
                with self._cond:
                    self._data[(t, pos)].append(
                        (producer, seq, port, shard, updates)
                    )
                    self._recv_pos_counts[(peer, t, pos)] += 1
                    self._cond.notify_all()
            elif kind == "D":
                _, t, pos, producer, entries = msg
                with self._cond:
                    bucket = self._data[(t, pos)]
                    for seq, port, shard, updates in entries:
                        bucket.append((producer, seq, port, shard, updates))
                    self._recv_pos_counts[(peer, t, pos)] += len(entries)
                    self._cond.notify_all()
            elif kind == "M":
                _, t, pos, counts = msg
                mine = counts.get(self.pid, {})
                with self._cond:
                    cur = self._marks[peer].get(t, -1)
                    if pos > cur:
                        self._marks[peer][t] = pos
                    if mine:
                        ann = self._announced.setdefault((peer, t), {})
                        for p, n in mine.items():
                            if n > ann.get(p, 0):
                                ann[p] = n
                    self._cond.notify_all()
            elif kind == "e":
                with self._cond:
                    self._eot.add((peer, msg[1]))
                    if msg[1] == self._SHUTDOWN_T:
                        # peer has no protocol traffic left; its eventual
                        # disconnect is a normal exit, not a failure
                        self._done_peers.add(peer)
                    self._cond.notify_all()
            elif kind == "c":
                self._ctl.put(msg[1])
            elif kind == "h":
                pass  # heartbeat: _last_seen above is the whole payload
            elif kind == "p":
                # coordinated abort: a peer failed and poisoned the mesh —
                # every blocking wait on this process raises ClusterAborted
                # from here on, and anyone blocked right now wakes up
                with self._cond:
                    if self._poisoned is None:
                        self._poisoned = str(msg[1])
                    self._ctl.put(("__poison__", self._poisoned))
                    self._cond.notify_all()
                for snd in self._senders.values():
                    with snd.cond:
                        snd.cond.notify_all()
        with self._cond:
            if not self._closed and peer not in self._done_peers:
                self._dead = f"peer {peer} disconnected"
                self._dead_peer = peer
                self._ctl.put(("__peer_lost__", peer))
            self._cond.notify_all()
        for snd in self._senders.values():
            with snd.cond:
                snd.cond.notify_all()

    def _check_locked(self, waiting_on: str = "fabric") -> None:
        if self._poisoned is not None:
            raise ClusterAborted(self._poisoned)
        if self._dead is not None:
            if self._dead_peer is not None:
                raise PeerLostError(self._dead_peer, waiting_on, self._dead)
            raise FabricError(self._dead)

    def _check(self, waiting_on: str = "fabric") -> None:
        self._check_locked(waiting_on)

    def _peer_stalled_locked(self, peer: int,
                             waiting_on: str) -> PeerLostError | None:
        """Liveness verdict for one peer this process is blocked on:
        silent past the heartbeat deadline => PeerLostError (None while
        heartbeats are disabled or the peer is within deadline)."""
        if self._hb_interval <= 0 or self._peer_timeout_s <= 0:
            return None
        age = _time.monotonic() - self._last_seen.get(peer, 0.0)
        if age <= self._peer_timeout_s:
            return None
        return PeerLostError(
            peer, waiting_on,
            f"no frames for {age:.1f}s (deadline {self._peer_timeout_s}s)",
        )

    def poison(self, reason: str) -> None:
        """Broadcast a coordinated-abort frame to every peer (best
        effort; bypasses the dead-fabric check — the whole point is that
        something already failed).  Survivors raise ClusterAborted from
        their current blocking wait instead of each timing out alone."""
        for snd in self._senders.values():
            try:
                with snd.cond:
                    if snd.stopped:
                        continue
                    snd.ctl.append(("p", reason))
                    snd.cond.notify_all()
            except Exception:  # noqa: BLE001 - poison is best-effort
                pass
        try:
            self.flush(timeout_s=5.0)
        except Exception:  # noqa: BLE001 - a dead sender cannot flush
            pass

    # -- counted mark-point wait -------------------------------------------
    def _mark_ready(self, peer: int, time: int, pos: int) -> bool:
        """(caller holds _cond)  Peer's exchange point (time, pos) is
        complete: its cursor passed pos AND every frame it announced for
        (time, pos) has landed."""
        if self._marks[peer].get(time, -1) < pos:
            return False
        ann = self._announced.get((peer, time))
        if not ann:
            return True
        # the mark count-proves every position AT OR BELOW the marked
        # one: announced counts for pos' <= pos are final when the mark
        # posts (frames targeting pos' are produced strictly before the
        # peer crosses pos), so a control-lane mark that overtook its
        # bulk data still blocks here until those frames land — checking
        # only ann[pos] let a mark posted past the data's position open
        # the barrier with the frames still in flight
        for p, need in ann.items():
            if p <= pos and self._recv_pos_counts.get(
                    (peer, time, p), 0) < need:
                return False
        return True

    def wait_marks(self, time: int, pos: int,
                   timeout_s: float | None = None) -> None:
        """Block until every peer's (time, pos) exchange point is
        count-proven complete (cursor >= pos and announced-frame counts
        matched).  Quiet points complete on the control-lane mark alone;
        the wait only blocks on bytes when frames are genuinely in flight.

        the wait is attributed PER PEER — each peer's
        ``wait_marks_s_p<pid>`` accumulates how long it kept this process
        at the barrier, so a 2-proc `wait_marks_s` spike names its
        straggler — and waits land as ``fabric.wait_marks`` spans.

        the wait is DEADLINED.  A peer silent past the
        heartbeat deadline, or an exchange point still incomplete at
        ``timeout_s`` (default ``PW_FABRIC_WAIT_TIMEOUT_S``), raises a
        typed :class:`PeerLostError` naming the peer and the barrier —
        a dropped frame or dead process aborts the mesh instead of
        hanging it."""
        waiting_on = f"marks(t={time}, pos={pos})"
        if timeout_s is None:
            timeout_s = self._wait_timeout_s
        deadline = _time.monotonic() + timeout_s
        t0 = _time.perf_counter()
        remaining = set(self.peers)
        with self._cond:
            while True:
                # success test before the death check: a peer that already
                # delivered its mark may legitimately be gone by now
                now = _time.perf_counter()
                for p in [p for p in remaining
                          if self._mark_ready(p, time, pos)]:
                    self.stats[f"wait_marks_s_p{p}"] += now - t0
                    remaining.discard(p)
                if not remaining:
                    self.stats["wait_marks_s"] += now - t0
                    obs.record_span("fabric.wait_marks", t0, now,
                                    ctx=self._obs_ctx, time=time, pos=pos)
                    return
                self._check_locked(waiting_on)
                for p in remaining:
                    err = self._peer_stalled_locked(p, waiting_on)
                    if err is not None:
                        raise err
                if not self._cond.wait(timeout=min(1.0, deadline - _time.monotonic())):
                    if _time.monotonic() > deadline:
                        raise PeerLostError(
                            min(remaining), waiting_on,
                            f"barrier still incomplete after {timeout_s}s "
                            f"(peers {sorted(remaining)})",
                        )

    def wait_eot(self, time: int, timeout_s: float | None = None) -> None:
        waiting_on = f"eot(t={time})"
        if timeout_s is None:
            timeout_s = self._wait_timeout_s
        deadline = _time.monotonic() + timeout_s
        t0 = _time.perf_counter()
        with self._cond:
            while True:
                if all((p, time) in self._eot for p in self.peers):
                    # drop barrier bookkeeping for this time
                    for p in self.peers:
                        self._eot.discard((p, time))
                        self._marks[p].pop(time, None)
                    self.stats["wait_eot_s"] += _time.perf_counter() - t0
                    return
                self._check_locked(waiting_on)
                for p in self.peers:
                    if (p, time) in self._eot:
                        continue
                    err = self._peer_stalled_locked(p, waiting_on)
                    if err is not None:
                        raise err
                if not self._cond.wait(timeout=min(1.0, deadline - _time.monotonic())):
                    if _time.monotonic() > deadline:
                        stalled = [p for p in self.peers
                                   if (p, time) not in self._eot]
                        raise PeerLostError(
                            min(stalled) if stalled else -1, waiting_on,
                            f"eot barrier still incomplete after "
                            f"{timeout_s}s (peers {sorted(stalled)})",
                        )

    # -- vouched sends ------------------
    def vouched_min(self) -> int | None:
        """Minimum target logical time among out-of-walk sends this
        process still answers for in the min-agreement round.  The sender
        vouches until it has itself processed the target time: the agreed
        walk then guarantees every receiver count-proved the delivery at
        its mark points (``confirm_below``)."""
        with self._cond:
            return min(self._vouched) if self._vouched else None

    def confirm_below(self, time: int) -> None:
        """Drop vouches for sends targeting times <= ``time`` — this
        process has run those times under the agreement, so their counted
        mark points (which include every cross-time frame in their
        announced counts) proved delivery everywhere."""
        with self._cond:
            for t in [t for t in self._vouched if t <= time]:
                del self._vouched[t]

    def prune_marks(self, below_time: int) -> None:
        """Drop mark/count bookkeeping for logical times < ``below_time``
        (times are processed in ascending order, so older marks can never
        gate a future wait; a late straggler send recreates symmetric
        fresh entries on both sides — both pruned their history at the
        same processed times — cleaned by the next call)."""
        with self._cond:
            for marks in self._marks.values():
                for t in [t for t in marks if t < below_time]:
                    del marks[t]
            for key in [k for k in self._announced if k[1] < below_time]:
                del self._announced[key]
            for key in [k for k in self._recv_pos_counts
                        if k[1] < below_time]:
                del self._recv_pos_counts[key]
            for t in [t for t in self._sent_by_time if t < below_time]:
                del self._sent_by_time[t]

    def pending_times(self) -> set[int]:
        """Times with stashed remote data not yet taken."""
        with self._cond:
            return {t for (t, _pos) in self._data}

    def take_data(self, time: int, pos: int) -> list:
        """Remote batches for (time, pos), deterministically ordered."""
        with self._cond:
            batches = self._data.pop((time, pos), [])
        batches.sort(key=lambda b: (b[0], b[1]))  # (producer, seq)
        return batches

    def recv_ctl(self, timeout_s: float | None = None,
                 waiting_on: str = "ctl") -> Any:
        # NOTE: no blanket wait_ctl_s accounting here — a streaming
        # worker blocks in recv_ctl waiting for the coordinator's next
        # TICK (idle scheduling, not round cost), which would swamp the
        # time split.  ClusterRunner._timed_recv_ctl bills its waits to
        # an explicit stat (wait_ctl_s inside the min round, wait_sync_s
        # for gather/broadcast rendezvous).
        #
        # the blocking get polls in 1s slices so peer-liveness
        # and poison are checked while waiting — a dead coordinator (or
        # a poisoned mesh) raises typed within the heartbeat deadline
        # instead of sitting out the full ctl timeout.
        if timeout_s is None:
            timeout_s = self._wait_timeout_s
        deadline = _time.monotonic() + timeout_s
        while True:
            try:
                msg = self._ctl.get(
                    timeout=min(1.0, max(deadline - _time.monotonic(), 0.01))
                )
            except queue.Empty:
                with self._cond:
                    if self._poisoned is not None:
                        raise ClusterAborted(self._poisoned)
                    for p in self.peers:
                        if p in self._done_peers:
                            continue
                        err = self._peer_stalled_locked(p, waiting_on)
                        if err is not None:
                            raise err
                if _time.monotonic() > deadline:
                    raise FabricError(
                        f"pid {self.pid}: ctl recv timeout "
                        f"(waiting on {waiting_on})"
                    )
                continue
            if isinstance(msg, tuple) and msg and msg[0] == "__peer_lost__":
                if self._closed:
                    raise FabricError("fabric closed")
                raise PeerLostError(msg[1], waiting_on, "peer disconnected")
            if isinstance(msg, tuple) and msg and msg[0] == "__poison__":
                raise ClusterAborted(str(msg[1]))
            return msg

    _SHUTDOWN_T = -(1 << 62)

    def shutdown_barrier(self, timeout_s: float = 120.0) -> None:
        """Rendezvous before teardown: once every peer reaches this point no
        protocol message is outstanding, so the subsequent socket closes
        cannot be mistaken for failures."""
        self.flush(timeout_s)
        self.send_eot(self._SHUTDOWN_T)
        self.wait_eot(self._SHUTDOWN_T, timeout_s=timeout_s)
        self.flush(timeout_s)
        self._closed = True

    def close(self) -> None:
        self._closed = True
        for snd in getattr(self, "_senders", {}).values():
            snd.stop()
        for sock in self._socks.values():
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                sock.close()
            except OSError:
                pass
