"""Daemon mode: a resident process that runs tool commands over a unix
socket (the twin of cvsim_tpu.cli.serve).

A one-shot command pays the interpreter, the torch import, the CUDA
context and the kernels' build or load (`kernels.load()`: nvcc on a
cold `_build/`, a dlopen on a warm one) before its first field. A
resident server pays them once:

    python -m cvsim_tpu_torch [--device cpu] serve [-socket /path.sock] [-prime] &
    python -m cvsim_tpu_torch -via /path.sock to-composite -i in.y4m -o out.y4m -vhs ...

`-prime` runs the flagship gen-1 GOP step (kernel #5 on the card) on a
dummy GOP on the server's device before the first client command is
served, under the command lock. A prime that fails ends `serve` with a
non-zero exit and the error on stderr.

The forwarded argv goes through cli/main.main unchanged, a leading
`--device` included: a client command runs on the card unless it asks
for the CPU. The `-via` client is stdlib-only and is dispatched from
__main__.py before any heavy import, so `python -S -m cvsim_tpu_torch
-via ...` works.

Protocol (line-JSON over SOCK_STREAM): client sends {"argv": [...],
"cwd": "..."}, server streams {"err": "..."} progress lines and one final
{"rc": N}. Commands run one at a time, in the client's working directory
(the server chdirs under the command lock). The socket is same-user: it
lives in XDG_RUNTIME_DIR or a 0700 per-uid directory under the temp
directory and is chmod 0600.
"""

from __future__ import annotations

import json
import os
import socket
import socketserver
import sys
import tempfile
import threading
import time
import traceback


def default_socket() -> str:
    run_dir = os.environ.get("XDG_RUNTIME_DIR")
    if not run_dir:
        run_dir = os.path.join(tempfile.gettempdir(),
                               f"cvsim-{os.getuid()}")
        os.makedirs(run_dir, mode=0o700, exist_ok=True)
        os.chmod(run_dir, 0o700)
    return os.path.join(run_dir, "cvsim.sock")


# threads currently inside run_via (an in-process client echoing server
# progress to stderr must not loop it back into the socket)
_via_threads: set = set()


class _TeeErr:
    """stderr tee: forward tool progress to the client socket. The
    pipeline prints from worker threads (cvsim-write progress lines,
    CVSIM_PHASES stamps), so ALL threads forward — except threads inside
    run_via (see _via_threads) and the server's own accept loop."""

    def __init__(self, wfile, fallback, skip_idents):
        self.wfile = wfile
        self.fallback = fallback
        self.skip = skip_idents

    def write(self, s):
        if not s:
            return 0
        ident = threading.get_ident()
        if ident in self.skip or ident in _via_threads:
            return self._fall(s)
        try:
            self.wfile.write((json.dumps({"err": s}) + "\n").encode())
            self.wfile.flush()
        except OSError:
            return self._fall(s)
        return len(s)

    def _fall(self, s):
        try:
            self.fallback.write(s)
        except (OSError, ValueError):   # closed capture file etc.
            pass
        return len(s)

    def flush(self):
        pass


def _prime_gen1(device):
    """Run the flagship gen-1 GOP step (-vhs -vhs-speed ep, a 480x704
    4:2:0 source) once on a dummy GOP on `device` and wait for it: the
    kernels are built or loaded and the card warmed before the first
    client command. Raises on any failure."""
    from cvsim_tpu_torch import presets
    from cvsim_tpu_torch.host.pipeline import CompositePipeline

    st = presets.parse_composite_flags(["-vhs", "-vhs-speed", "ep"],
                                       gen2=False)
    cfg = st.to_run_config(gen1=True)
    pipe = CompositePipeline(cfg, progress=False, device=device)
    pipe.prime(480, 704, 240, 352, False, True)


def run_serve(argv, device="cuda", ready=None, stop=None) -> int:
    """`serve` with flags argv on `device` (the device `-prime` runs on;
    each client command names its own). For a caller that runs the
    server in a thread: `ready` (a threading.Event) is set once the
    server accepts commands, after the prime; setting `stop` (another)
    ends it."""
    sock_path = None
    prime = False
    one_shot = False          # test hook: exit after one connection
    i = 0
    while i < len(argv):
        a = argv[i].lstrip("-")
        i += 1
        if a == "socket":
            if i >= len(argv):
                print("-socket needs a path", file=sys.stderr)
                return 1
            sock_path = argv[i]; i += 1
        elif a == "prime":
            prime = True
        elif a == "one-shot":
            one_shot = True
        else:
            print(f"Unknown switch '{a}'", file=sys.stderr)
            return 1
    if sock_path is None:
        sock_path = default_socket()

    from cvsim_tpu_torch.cli import main as climain

    lock = threading.Lock()
    server_idents = {threading.get_ident()}

    class Handler(socketserver.StreamRequestHandler):
        def handle(self):
            try:
                line = self.rfile.readline()
                if not line:
                    return
                req = json.loads(line)
            except (ValueError, OSError):
                return
            with lock:                      # one device, one command at a time
                old = sys.stderr
                sys.stderr = _TeeErr(self.wfile, old, server_idents)
                old_cwd = os.getcwd()
                try:
                    # relative -i/-o paths resolve in the CLIENT's cwd;
                    # chdir is process-global but commands serialize here
                    if req.get("cwd"):
                        os.chdir(req["cwd"])
                    rc = climain.main(req.get("argv", []))
                except SystemExit as e:
                    # SystemExit.code may be a message string (sys.exit("x"))
                    if isinstance(e.code, int) or e.code is None:
                        rc = int(e.code or 0)
                    else:
                        print(f"cvsim serve: {e.code}", file=sys.stderr)
                        rc = 1
                except BaseException as e:   # report, keep serving
                    print(f"cvsim serve: {type(e).__name__}: {e}",
                          file=sys.stderr)
                    rc = 1
                finally:
                    try:
                        os.chdir(old_cwd)
                    except OSError:
                        pass
                    sys.stderr = old
            try:
                self.wfile.write((json.dumps({"rc": rc}) + "\n").encode())
            except OSError:
                pass

    if os.path.exists(sock_path):
        os.unlink(sock_path)

    class Server(socketserver.ThreadingUnixStreamServer):
        daemon_threads = True

    srv = Server(sock_path, Handler)
    os.chmod(sock_path, 0o600)
    print(f"cvsim serve: listening on {sock_path}", file=sys.stderr)
    try:
        if prime:
            # clients that connect meanwhile wait in the listen backlog
            t0 = time.perf_counter()
            with lock:
                try:
                    _prime_gen1(device)
                except Exception as e:
                    traceback.print_exc(file=sys.stderr)
                    print(f"cvsim serve: -prime failed: "
                          f"{type(e).__name__}: {e}", file=sys.stderr)
                    return 1
            print(f"cvsim serve: primed in {time.perf_counter() - t0:.3f} s",
                  file=sys.stderr)
        if ready is not None:
            ready.set()
        if stop is not None:
            threading.Thread(target=lambda: (stop.wait(), srv.shutdown()),
                             daemon=True).start()
        if one_shot:
            srv.handle_request()
        else:
            srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.server_close()
        try:
            os.unlink(sock_path)
        except OSError:
            pass
    return 0


def run_via(sock_path: str, argv) -> int:
    """Client: forward argv to a running `cvsim serve`, stream its progress
    to stderr, return its exit code."""
    ident = threading.get_ident()
    _via_threads.add(ident)
    try:
        with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as s:
            try:
                s.connect(sock_path)
            except OSError as e:
                print(f"cvsim -via: cannot reach server at {sock_path}: {e}"
                      "\n(start one with: python -m cvsim_tpu_torch serve "
                      "-prime &)", file=sys.stderr)
                return 1
            s.sendall((json.dumps({"argv": list(argv),
                                   "cwd": os.getcwd()}) + "\n").encode())
            f = s.makefile("rb")
            for line in f:
                try:
                    msg = json.loads(line)
                except ValueError:
                    continue
                if "err" in msg:
                    sys.stderr.write(msg["err"])
                    sys.stderr.flush()
                if "rc" in msg:
                    return int(msg["rc"])
        print("cvsim -via: server closed without a result", file=sys.stderr)
        return 1
    finally:
        _via_threads.discard(ident)
