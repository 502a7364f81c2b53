"""twopaco server mode: a resident daemon that runs CLI requests warm.

Why: a cold CLI process pays the interpreter + JAX import, the device
client's start-up and every jit compile (or persistent-cache load)
before any work happens, which is far more than an E. coli-sized build
itself. The reference binary (constructor.cpp) starts in milliseconds;
matching its small-input latency requires amortizing our runtime boot
across invocations. The daemon owns the device and the in-memory jit
cache; clients are thin (native/tpclient.c, ~ms) and stream argv in /
stdout+stderr back over a unix socket.

Protocol (length-prefixed, binary-safe):
  request:  u32le n + n bytes JSON {"tool": "twopaco"|"graphdump"|
            "naive", "argv": [...], "cwd": "..."}
  response: frames of tag byte 'O' (stdout) / 'E' (stderr) + u32le n +
            n bytes, terminated by tag 'X' + u32le exit-code.

One request runs at a time: the daemon's JAX process holds most of the
device's memory, and two computations on one device would only take
turns. The daemon is single-host plumbing around the framework; the
compute path is unchanged.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import struct
import sys
import tempfile
import traceback

# under $TMPDIR, so checkouts with temp dirs of their own never share a
# daemon; native/tpclient.c builds the same default
DEFAULT_SOCKET = os.environ.get("TWOPACO_SERVER_SOCKET") or os.path.join(
    tempfile.gettempdir(), "twopaco_tpu.sock"
)


class _FrameWriter:
    """File-like that forwards writes as tagged frames on the socket."""

    def __init__(self, conn: socket.socket, tag: bytes) -> None:
        self._conn = conn
        self._tag = tag

    def write(self, s) -> int:
        data = s.encode() if isinstance(s, str) else bytes(s)
        if data:
            self._conn.sendall(self._tag + struct.pack("<I", len(data)) + data)
        return len(s)

    def flush(self) -> None:  # frames are unbuffered
        pass


def _recv_exact(conn: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = conn.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("client closed mid-request")
        buf += chunk
    return buf


def _dispatch(tool: str, argv: list[str]) -> int:
    if tool == "twopaco":
        from twopaco_tpu.cli import twopaco as mod
    elif tool == "graphdump":
        from twopaco_tpu.cli import graphdump as mod
    elif tool == "naive":
        from twopaco_tpu.cli import naive as mod
    else:
        raise ValueError(f"unknown tool {tool!r}")
    return mod.main(argv)


def _serve_one(conn: socket.socket) -> bool:
    """Handle one request; returns False if the daemon should stop."""
    (n,) = struct.unpack("<I", _recv_exact(conn, 4))
    req = json.loads(_recv_exact(conn, n))
    if req.get("tool") == "__shutdown__":
        conn.sendall(b"X" + struct.pack("<I", 0))
        return False
    out = _FrameWriter(conn, b"O")
    err = _FrameWriter(conn, b"E")
    old = sys.stdout, sys.stderr, os.getcwd()
    rc = 1
    try:
        sys.stdout, sys.stderr = out, err
        if req.get("cwd"):
            os.chdir(req["cwd"])
        # argparse calls sys.exit on -h/usage errors; map to rc
        try:
            rc = int(_dispatch(req["tool"], req["argv"]) or 0)
        except SystemExit as e:
            rc = int(e.code or 0)
    except Exception:
        err.write(traceback.format_exc())
        rc = 1
    finally:
        sys.stdout, sys.stderr = old[0], old[1]
        try:
            os.chdir(old[2])
        except OSError:
            pass
    conn.sendall(b"X" + struct.pack("<I", rc))
    return True


def warm():
    """Start the device client and import the compute stack up front,
    so the first client request doesn't pay it; returns the device."""
    import jax

    from twopaco_tpu import passes  # noqa: F401
    from twopaco_tpu.formats import graphdump  # noqa: F401

    # resident process: the one-time compile (or cache load) of the big
    # sort programs amortizes across requests, so serve the
    # fewest-rounds configuration (cli/twopaco.py sort_chunk tiering)
    os.environ.setdefault("TWOPACO_SORT_CHUNK", str(1 << 26))
    return jax.devices()[0]


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="twopaco-serve")
    p.add_argument("--socket", default=DEFAULT_SOCKET)
    p.add_argument(
        "--idle-timeout", type=float,
        default=float(os.environ.get("TWOPACO_SERVER_IDLE_S", 1800)),
        help="Exit after this many seconds with no requests (0 = never);"
        " the daemon holds most of the device's memory, so an"
        " abandoned server must release it on its own",
    )
    args = p.parse_args(argv)

    try:
        os.unlink(args.socket)
    except OSError:
        pass
    srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    srv.bind(args.socket)
    srv.listen(8)
    dev = warm()
    print(
        f"twopaco server ready on {args.socket} "
        f"(platform {dev.platform}, {dev.device_kind})",
        flush=True,
    )
    try:
        while True:
            if args.idle_timeout:
                srv.settimeout(args.idle_timeout)
            try:
                conn, _ = srv.accept()
            except socket.timeout:
                print("idle timeout — exiting", flush=True)
                return 0
            with conn:
                try:
                    if not _serve_one(conn):
                        return 0
                except (ConnectionError, OSError) as e:
                    print(f"request aborted: {e}", file=sys.stderr, flush=True)
    finally:
        srv.close()
        try:
            os.unlink(args.socket)
        except OSError:
            pass


if __name__ == "__main__":
    sys.exit(main())
