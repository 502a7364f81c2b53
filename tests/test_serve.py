"""Server mode (cli/serve.py): protocol round-trip, output parity with
the direct CLI, error paths, and the native client if built."""

import json
import os
import socket
import struct
import subprocess
import sys
import time

import pytest

from tests.conftest import EXAMPLE_FA as EXAMPLE

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TPCLIENT = os.path.join(REPO, "native", "build", "tpclient")


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    sock_path = str(tmp_path_factory.mktemp("srv") / "tp.sock")
    env = dict(os.environ, JAX_PLATFORMS="cpu", TWOPACO_SERVER_SOCKET=sock_path)
    proc = subprocess.Popen(
        [sys.executable, "-m", "twopaco_tpu.cli.serve",
         "--socket", sock_path],
        cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
    )
    for _ in range(600):
        if os.path.exists(sock_path):
            break
        if proc.poll() is not None:
            raise RuntimeError(
                f"server died: {proc.stdout.read().decode()}"
            )
        time.sleep(0.2)
    else:
        proc.kill()
        raise RuntimeError("server socket never appeared")
    yield sock_path
    proc.terminate()
    proc.wait(timeout=30)


def request(sock_path, tool, argv, cwd=None):
    """Python mini-client speaking the tpclient protocol."""
    conn = socket.create_connection  # noqa: F841  (unix below)
    s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    s.connect(sock_path)
    req = json.dumps(
        {"tool": tool, "argv": argv, "cwd": cwd or os.getcwd()}
    ).encode()
    s.sendall(struct.pack("<I", len(req)) + req)

    def recv_exact(n):
        buf = b""
        while len(buf) < n:
            chunk = s.recv(n - len(buf))
            assert chunk, "server closed mid-response"
            buf += chunk
        return buf

    out, err = b"", b""
    while True:
        tag = recv_exact(1)
        (n,) = struct.unpack("<I", recv_exact(4))
        if tag == b"X":
            s.close()
            return n, out.decode(), err.decode()
        payload = recv_exact(n)
        if tag == b"O":
            out += payload
        else:
            err += payload


def test_twopaco_round_trip(server, tmp_path):
    out = str(tmp_path / "srv.dbg")
    rc, stdout, _ = request(
        server, "twopaco",
        ["-k", "11", "-f", "16", "-o", out, EXAMPLE],
    )
    assert rc == 0
    assert "Distinct junctions" in stdout
    # byte parity with the direct CLI
    direct = str(tmp_path / "direct.dbg")
    from twopaco_tpu.cli import twopaco as cli

    assert cli.main(["-k", "11", "-f", "16", "-o", direct, EXAMPLE]) == 0
    assert open(out, "rb").read() == open(direct, "rb").read()


def test_graphdump_round_trip(server, tmp_path):
    out = str(tmp_path / "srv.dbg")
    rc, _, _ = request(
        server, "twopaco", ["-k", "11", "-f", "16", "-o", out, EXAMPLE]
    )
    assert rc == 0
    rc, text, _ = request(
        server, "graphdump", ["-f", "group", "-k", "11", out]
    )
    assert rc == 0
    golden = open(
        os.path.join(REPO, "tests", "golden", "example_k11.group")
    ).read()
    assert sorted(text.splitlines()) == sorted(golden.splitlines())


def test_bad_args_dont_kill_server(server, tmp_path):
    rc, _, err = request(server, "twopaco", ["-k", "12", "/nope.fa"])
    assert rc == 1
    assert "odd" in err or "Error" in err
    rc, _, _ = request(server, "twopaco", ["--definitely-not-a-flag"])
    assert rc != 0
    # server still alive and serving
    out = str(tmp_path / "after.dbg")
    rc, _, _ = request(
        server, "twopaco", ["-k", "11", "-f", "16", "-o", out, EXAMPLE]
    )
    assert rc == 0


def test_unknown_tool(server):
    rc, _, err = request(server, "nonsense", [])
    assert rc == 1
    assert "unknown tool" in err


@pytest.mark.skipif(
    not os.path.exists(TPCLIENT), reason="native client not built"
)
def test_native_client(server, tmp_path):
    out = str(tmp_path / "cli.dbg")
    env = dict(os.environ, TWOPACO_SERVER_SOCKET=server)
    r = subprocess.run(
        [TPCLIENT, "twopaco", "-k", "11", "-f", "16", "-o", out, EXAMPLE],
        env=env, capture_output=True, text=True, timeout=300,
    )
    assert r.returncode == 0, r.stderr
    assert "Distinct junctions" in r.stdout
    r2 = subprocess.run(
        [TPCLIENT, "twopaco", "-k", "12", "x.fa"],
        env=env, capture_output=True, text=True, timeout=300,
    )
    assert r2.returncode == 1
    assert "odd" in r2.stderr
