"""Resident solve server: one process owns the accelerator, clients
dispatch solves to it.

A `padne-tpu serve` process initializes the device once, keeps its
compiled programs, and caches the set-up solver of the last board it
saw.  While it runs, every `padne-tpu solve` (solver.solve) ships its
assembled system over a unix socket, gets the solution back, and stays
on the CPU itself: one process per card, since a second JAX process
would find most of the card's memory reserved.  Repeat solves of the
SAME system (same structural hash) reuse the cached solver.

The reference has no equivalent (single-process scipy,
ref solver.py:767-780).

Wire protocol (version 1, both directions):
    8-byte big-endian frame length, then an .npz payload.
Request npz keys: kind ("ping" | "solve" | "shutdown"); solve adds the
CoreSystem/BorderSpec flat arrays (see _system_to_npz) plus
target_residual and max_refinements.  Response npz: ok (1/0) and
either the BorderedSolution arrays or err (utf-8 message).

Security note: the socket is created with 0700 directory / 0600 file
permissions in the user's own cache dir — same trust domain as the
user's files.  The payload is plain arrays (np.load with
allow_pickle=False), never pickled objects.
"""

from __future__ import annotations

import io
import logging
import os
import pathlib
import socket
import struct
import time

import numpy as np

log = logging.getLogger(__name__)

PROTOCOL_VERSION = 1


def default_socket_path() -> str:
    """$PADNE_TPU_SOCKET, or ~/.cache/padne_tpu/serve.sock."""
    env = os.environ.get("PADNE_TPU_SOCKET")
    if env:
        return env
    base = pathlib.Path(os.environ.get(
        "XDG_CACHE_HOME", pathlib.Path.home() / ".cache")) / "padne_tpu"
    return str(base / "serve.sock")


# ---------------------------------------------------------------------------
# Framing + npz payloads
# ---------------------------------------------------------------------------
_MAX_FRAME = 16 << 30  # sanity bound, not a real limit


def _send_frame(sock: socket.socket, payload: bytes) -> None:
    sock.sendall(struct.pack(">Q", len(payload)))
    sock.sendall(payload)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(min(n - len(buf), 1 << 20))
        if not chunk:
            raise ConnectionError("peer closed mid-frame")
        buf += chunk
    return bytes(buf)


def _recv_frame(sock: socket.socket) -> bytes:
    (n,) = struct.unpack(">Q", _recv_exact(sock, 8))
    if n > _MAX_FRAME:
        raise ValueError(f"frame length {n} exceeds sanity bound")
    return _recv_exact(sock, n)


def _pack(**arrays) -> bytes:
    bio = io.BytesIO()
    np.savez(bio, **arrays)
    return bio.getvalue()


def _unpack(payload: bytes) -> dict:
    z = np.load(io.BytesIO(payload), allow_pickle=False)
    return {k: z[k] for k in z.files}


def _system_to_npz(system) -> dict:
    """CoreSystem + BorderSpec as flat arrays (mirrors bench's probe
    snapshot format)."""
    b = system.border
    out = dict(
        n=np.int64(system.n), cols=system.ell.cols, vals=system.ell.vals,
        diag=system.ell.diag, comp_id=system.comp_id,
        num_components=np.int64(system.num_components),
        r_core=system.r_core, ground_var=np.int64(system.ground_var),
        m=np.int64(b.m),
        row_idx=b.row_idx, row_node=b.row_node, row_val=b.row_val,
        col_idx=b.col_idx, col_node=b.col_node, col_val=b.col_val,
        rhs=b.rhs,
    )
    if system.coords is not None:
        out["coords"] = system.coords
    if system.group is not None:
        out["group"] = system.group
    return out


def _system_from_npz(z: dict):
    from .ops import assembly, schur

    border = schur.BorderSpec(
        m=int(z["m"]), row_idx=z["row_idx"], row_node=z["row_node"],
        row_val=z["row_val"], col_idx=z["col_idx"],
        col_node=z["col_node"], col_val=z["col_val"], rhs=z["rhs"],
    )
    return schur.CoreSystem(
        n=int(z["n"]),
        ell=assembly.EllMatrix(cols=z["cols"], vals=z["vals"],
                               diag=z["diag"]),
        comp_id=z["comp_id"], num_components=int(z["num_components"]),
        border=border, r_core=z["r_core"],
        ground_var=int(z["ground_var"]), coords=z.get("coords"),
        group=z.get("group"),
    )


def _structural_key(z: dict) -> str:
    """Hash of the OPERATOR structure+values (not the RHS): solves of
    the same board with different excitations still reuse the cached
    solver (its hierarchy depends only on the operator)."""
    import hashlib

    h = hashlib.sha256()
    for k in ("cols", "vals", "diag", "comp_id", "row_idx", "row_node",
              "row_val", "col_idx", "col_node", "col_val",
              "ground_var"):
        a = np.ascontiguousarray(z[k])
        h.update(k.encode())
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
    return h.hexdigest()


# ---------------------------------------------------------------------------
# Server
# ---------------------------------------------------------------------------
class _SolverCache:
    """Most-recently-used DiaBorderedSolver per structural hash.

    Capacity defaults to 1: a 1M-DoF solver pins multi-GB of HBM
    (slabs + hierarchy + comp streams); evicting on new structure keeps
    the resident set bounded.  PADNE_TPU_SERVE_CACHE overrides.
    """

    def __init__(self, capacity: int | None = None):
        if capacity is None:
            capacity = int(os.environ.get("PADNE_TPU_SERVE_CACHE", "1"))
        self.capacity = max(1, capacity)
        self._items: dict = {}   # key -> (solver, system)

    def get(self, key):
        item = self._items.pop(key, None)
        if item is not None:
            self._items[key] = item   # refresh recency
        return item

    def put(self, key, solver, system):
        while len(self._items) >= self.capacity:
            old_key = next(iter(self._items))
            self._items.pop(old_key)
            log.info("serve: evicted cached solver %s", old_key[:12])
        self._items[key] = (solver, system)


def _handle_solve(z: dict, cache: _SolverCache) -> bytes:
    from .ops import schur

    t0 = time.time()
    key = _structural_key(z)
    cached = cache.get(key)
    if cached is not None and getattr(cached[0], "_anchor", None) \
            is not None:
        # The opt-in f64 device anchor bakes r_core into device arrays
        # at setup; an in-place RHS refresh would leave it evaluating
        # residuals against the OLD excitation (wrong answer with a
        # confidently small reported residual).  Rebuild instead.
        cached = None
    setup_seconds = 0.0
    if cached is None:
        system = _system_from_npz(z)
        t1 = time.time()
        try:
            solver = schur.DiaBorderedSolver(system)
        except schur._NoDiaHierarchy:
            # Small systems (below the AMG coarse floor) take the
            # generic bordered path, uncached (it sets up in well under
            # a second).
            solver = None
        except Exception:
            # Real server faults (HBM exhaustion, setup bugs) must be
            # visible server-side, not masked as "too small".
            log.exception("serve: solver setup failed (n=%d)",
                          int(z["n"]))
            return _pack(ok=np.int8(0), err=np.frombuffer(
                b"server solver setup failed (see server log); solve "
                b"locally", dtype=np.uint8))
        setup_seconds = time.time() - t1
        if solver is not None:
            cache.put(key, solver, system)
    else:
        solver, system = cached
        # Refresh the excitation: the cached solver reads r_core and
        # border.rhs from its system object.  The comp ladder's b64
        # cache is keyed by r_core object identity, so in-place
        # mutation must drop it explicitly.
        system.r_core[:] = z["r_core"]
        system.border.rhs[:] = z["rhs"]
        solver._b64_cache = None
    target = float(z["target_residual"])
    max_ref = int(z["max_refinements"])
    t1 = time.time()
    if solver is None:
        result = schur.solve_bordered(
            system, target_residual=target, max_refinements=max_ref,
            device_dtype=schur.default_device_dtype())
    else:
        result = solver.solve(target_residual=target,
                              max_refinements=max_ref)
    solve_seconds = time.time() - t1
    log.info("serve: solved n=%d in %.2fs (setup %.2fs, total %.2fs)",
             int(z["n"]), solve_seconds, setup_seconds, time.time() - t0)
    return _pack(
        ok=np.int8(1), v=np.asarray(result.v),
        j=np.asarray(result.j),
        residual_norm=np.float64(result.residual_norm),
        ground_current=np.float64(result.ground_current),
        cg_iterations=np.int64(result.cg_iterations),
        refinement_steps=np.int64(result.refinement_steps),
        refinement_ladder=np.frombuffer(
            result.refinement_ladder.encode(), dtype=np.uint8),
        setup_seconds=np.float64(setup_seconds),
        solve_seconds=np.float64(solve_seconds),
    )


def serve(socket_path: str | None = None, max_requests: int | None = None,
          ready_event=None, preload=None) -> None:
    """Run the resident solve server (blocking accept loop).

    max_requests: exit after N requests (tests/probes); None = forever.
    ready_event: optional threading.Event set once listening.
    preload: optional list of (system, solver) pairs seeded into the
    solver cache (an embedding process hands over solvers it already
    built, so clients hit the warm path immediately — e.g. bench.py's
    serve probe).
    """
    from . import runtime

    runtime.enable_compile_cache()
    tighten_parent = socket_path is None
    path = pathlib.Path(socket_path or default_socket_path())
    path.parent.mkdir(parents=True, exist_ok=True)
    if tighten_parent:
        # Restrict ONLY the default ~/.cache/padne_tpu dir this code
        # itself creates.  A caller-supplied socket path may live in a
        # shared directory (e.g. /tmp) whose mode is none of our
        # business — chmod'ing /tmp to 0700 broke the whole machine
        # once (review finding, 2026-08-21).
        os.chmod(path.parent, 0o700)
    if path.exists():
        path.unlink()
    srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    srv.bind(str(path))
    os.chmod(path, 0o600)
    srv.listen(4)
    cache = _SolverCache()
    for system, solver in (preload or []):
        cache.put(_structural_key(_system_to_npz(system)), solver,
                  system)
    log.info("serve: listening on %s (pid %d)", path, os.getpid())
    if ready_event is not None:
        ready_event.set()
    served = 0
    try:
        while max_requests is None or served < max_requests:
            conn, _ = srv.accept()
            served += 1
            # Bound every connection: a client stalled mid-frame (the
            # system upload is hundreds of MB) must not wedge the
            # single-threaded accept loop forever.
            conn.settimeout(float(os.environ.get(
                "PADNE_TPU_SERVE_CONN_TIMEOUT", "600")))
            try:
                req = _unpack(_recv_frame(conn))
                kind = bytes(req["kind"]).decode()
                if kind == "ping":
                    import jax

                    _send_frame(conn, _pack(
                        ok=np.int8(1), pid=np.int64(os.getpid()),
                        version=np.int64(PROTOCOL_VERSION),
                        backend=np.frombuffer(
                            jax.default_backend().encode(),
                            dtype=np.uint8)))
                elif kind == "solve":
                    _send_frame(conn, _handle_solve(req, cache))
                elif kind == "shutdown":
                    _send_frame(conn, _pack(ok=np.int8(1)))
                    break
                else:
                    _send_frame(conn, _pack(
                        ok=np.int8(0), err=np.frombuffer(
                            f"unknown kind {kind!r}".encode(),
                            dtype=np.uint8)))
            except Exception:
                log.exception("serve: request failed")
                try:
                    _send_frame(conn, _pack(
                        ok=np.int8(0),
                        err=np.frombuffer(b"internal error (see server "
                                          b"log)", dtype=np.uint8)))
                except OSError:
                    pass
            finally:
                conn.close()
    finally:
        srv.close()
        if path.exists():
            path.unlink()


# ---------------------------------------------------------------------------
# Client
# ---------------------------------------------------------------------------
def _request(payload: bytes, socket_path: str | None = None,
             timeout: float = 600.0) -> dict:
    sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    sock.settimeout(timeout)
    try:
        sock.connect(socket_path or default_socket_path())
        _send_frame(sock, payload)
        return _unpack(_recv_frame(sock))
    finally:
        sock.close()


def ping(socket_path: str | None = None, timeout: float = 5.0):
    """Server liveness: dict with pid/backend, or None when absent."""
    try:
        resp = _request(_pack(kind=np.frombuffer(b"ping", dtype=np.uint8)),
                        socket_path, timeout=timeout)
    except (OSError, ValueError):
        return None
    if not int(resp.get("ok", 0)):
        return None
    return {"pid": int(resp["pid"]),
            "backend": bytes(resp["backend"]).decode()}


def find_server():
    """The live daemon's ping info plus its socket path, or None (no
    socket, no answer, or PADNE_TPU_SERVER=0).  Starts no JAX backend."""
    if os.environ.get("PADNE_TPU_SERVER", "1") == "0":
        return None
    path = default_socket_path()
    if not pathlib.Path(path).exists():
        return None
    info = ping(path)
    if info is None:
        return None
    return dict(info, socket=path)


def shutdown(socket_path: str | None = None) -> bool:
    try:
        resp = _request(
            _pack(kind=np.frombuffer(b"shutdown", dtype=np.uint8)),
            socket_path, timeout=10.0)
        return bool(int(resp.get("ok", 0)))
    except (OSError, ValueError):
        return False


def client_solve(system, target_residual: float,
                 max_refinements: int = 12,
                 socket_path: str | None = None):
    """Solve on the resident server; returns a BorderedSolution-shaped
    result or None when no server is reachable (caller solves locally).
    """
    from .ops import schur

    payload = dict(_system_to_npz(system))
    payload["kind"] = np.frombuffer(b"solve", dtype=np.uint8)
    payload["target_residual"] = np.float64(target_residual)
    payload["max_refinements"] = np.int64(max_refinements)
    try:
        resp = _request(_pack(**payload), socket_path)
    except Exception:
        # ANY transport/decode failure (refused socket, truncated or
        # malformed response, oversized frame) falls back to the local
        # solve — the contract is "server helps when healthy, never
        # blocks a solve".
        log.warning("serve: dispatch failed; solving locally",
                    exc_info=True)
        return None
    if not int(resp.get("ok", 0)):
        err = bytes(resp.get("err", b"")).decode(errors="replace")
        log.warning("serve: server declined the solve (%s); solving "
                    "locally", err)
        return None
    return schur.BorderedSolution(
        v=resp["v"], j=resp["j"],
        residual_norm=float(resp["residual_norm"]),
        ground_current=float(resp["ground_current"]),
        cg_iterations=int(resp["cg_iterations"]),
        refinement_steps=int(resp["refinement_steps"]),
        refinement_ladder=bytes(
            resp.get("refinement_ladder", b"")).decode(),
    )
