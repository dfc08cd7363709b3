"""HTTP benchmark service: the worker-host daemon of distributed mode.

Port of the original package's service.py, serving the port's local worker
group (PyTorch/CUDA device path). /info keeps "Service": "elbencho-tpu" and
the protocol version, so the two packages' masters and services drive each
other. A flag the port does not carry yet is refused when the master's
config is applied (Config.apply_wire -> check_args), with the same text as
on the command line; the master reports it framed by this host.

The original is a rebuild of the reference's source/HTTPService.{h,cpp}: port availability
pre-check (HTTPService.cpp:490-547), optional daemonization with a logfile
lock and stdio redirect (371-482), and the REST endpoints: /info (106-130),
/protocolversion (132-140), /status live stats (142-160), /benchresult
(162-190), /preparephase with protocol-version check + worker re-prepare
(192-268), /startphase (270-303), /interruptphase with optional quit
(305-336). The HTTP stack is Python's stdlib ThreadingHTTPServer instead of
the reference's vendored Simple-Web-Server.
"""

from __future__ import annotations

import fcntl
import getpass
import json
import os
import socket
import sys
import tempfile
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from . import __version__
from .common import PROTOCOL_VERSION, BenchPhase, Endpoint
from .config import Config
from .exceptions import ProgException
from .logger import LOGGER
from .stats import Statistics
from .workers.local import LocalWorkerGroup


class ServiceState:
    """Mutable benchmark state behind the endpoints."""

    def __init__(self, local_cfg: Config) -> None:
        self.local_cfg = local_cfg  # CLI config of the service (path override)
        self.cfg: Config | None = None  # active config from the master
        self.group: LocalWorkerGroup | None = None
        self.stats: Statistics | None = None
        self.phase = BenchPhase.IDLE
        self.bench_id = ""
        self.lock = threading.Lock()

    def teardown_group(self) -> None:
        if self.group is not None:
            try:
                self.group.teardown()
            except Exception as e:
                LOGGER.error(f"worker teardown failed: {e}")
            self.group = None

    def prepare(self, wire_cfg: dict) -> dict:
        """Handle /preparephase: kill old workers, apply the master's config,
        spawn fresh workers, reply with BenchPathInfo."""
        self.teardown_group()
        # a failed prepare must not leave stats pointing at the torn-down
        # group: /status must answer "no prepared benchmark", not crash
        self.stats = None
        self.cfg = None
        LOGGER.clear_err_history()
        cfg = Config(paths=list(self.local_cfg.paths),
                     tpu_ids=list(self.local_cfg.tpu_ids))
        cfg.apply_wire(wire_cfg)
        cfg.disable_live_stats = True
        group = LocalWorkerGroup(cfg)
        try:
            group.prepare()
        except Exception:
            group.teardown()
            raise
        self.cfg = cfg
        self.group = group
        self.stats = Statistics(cfg, self.group)
        self.phase = BenchPhase.IDLE
        self.bench_id = ""
        return cfg.bench_path_info().to_wire()

    def start_phase(self, phase: BenchPhase, bench_id: str) -> None:
        if self.group is None:
            raise ProgException("no prepared benchmark (POST /preparephase first)")
        self.phase = phase
        self.bench_id = bench_id
        self.group.start_phase(phase, bench_id)


class _Handler(BaseHTTPRequestHandler):
    state: ServiceState = None  # injected
    server_obj: ThreadingHTTPServer = None

    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # route access logs through our logger
        LOGGER.debug(f"http: {fmt % args}")

    # ------------------------------------------------------------- plumbing

    def _reply(self, code: int, payload: dict | str,
               content_type: str = "application/json") -> None:
        body = (json.dumps(payload) if isinstance(payload, dict)
                else payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _error(self, msg: str, code: int = 400) -> None:
        self._reply(code, {"Error": msg,
                           "ErrorHistory": LOGGER.get_err_history()})

    def _query(self) -> dict:
        q = urllib.parse.urlparse(self.path).query
        return {k: v[0] for k, v in urllib.parse.parse_qs(q).items()}

    @property
    def _route(self) -> str:
        return urllib.parse.urlparse(self.path).path

    # ------------------------------------------------------------ endpoints

    def do_GET(self):  # noqa: N802
        st = self.state
        try:
            route = self._route
            if route == Endpoint.INFO:
                self._reply(200, {
                    "Service": "elbencho-tpu", "Version": __version__,
                    "ProtocolVersion": PROTOCOL_VERSION,
                    "Hostname": socket.gethostname(), "Pid": os.getpid(),
                })
            elif route == Endpoint.PROTOCOL_VERSION:
                self._reply(200, {"ProtocolVersion": PROTOCOL_VERSION})
            elif route == Endpoint.METRICS:
                # live streaming observability (docs/CAMPAIGNS.md): always
                # answers 200 — with no prepared benchmark the scrape
                # carries the static families and ebt_scrape_ok 0, so a
                # poller distinguishes "service up, idle" from "down"
                from .metrics import PROM_CONTENT_TYPE, render_metrics

                with st.lock:
                    campaign = None
                    if st.cfg is not None and st.cfg.campaign_name:
                        campaign = (st.cfg.campaign_name,
                                    st.cfg.campaign_stage, "")
                    body = render_metrics(
                        st.group if st.stats is not None else None,
                        st.cfg, st.phase, role="service",
                        campaign=campaign)
                self._reply(200, body, content_type=PROM_CONTENT_TYPE)
            elif route == Endpoint.STATUS:
                with st.lock:
                    if st.stats is None:
                        self._error("no prepared benchmark")
                        return
                    self._reply(200, st.stats.live_stats_wire(st.phase,
                                                              st.bench_id))
            elif route == Endpoint.BENCH_RESULT:
                with st.lock:
                    if st.stats is None:
                        self._error("no prepared benchmark")
                        return
                    self._reply(200, st.stats.bench_result_wire(
                        st.phase, st.bench_id, LOGGER.get_err_history()))
            elif route == Endpoint.START_PHASE:
                q = self._query()
                with st.lock:
                    st.start_phase(BenchPhase(int(q.get("PhaseCode", 0))),
                                   q.get("BenchID", ""))
                self._reply(200, {})
            elif route == Endpoint.INTERRUPT_PHASE:
                q = self._query()
                with st.lock:
                    if st.group is not None:
                        st.group.interrupt()
                self._reply(200, {})
                if q.get("quit"):
                    LOGGER.info("service quitting by master request")
                    threading.Thread(target=self.server_obj.shutdown,
                                     daemon=True).start()
            else:
                self._error(f"unknown endpoint: {route}", 404)
        except ProgException as e:
            self._error(str(e))
        except Exception as e:
            LOGGER.error(f"service error on {self.path}: {e}")
            self._error(f"internal service error: {e}", 500)

    def do_POST(self):  # noqa: N802
        st = self.state
        try:
            # drain the body up front: replying on an error path with unread
            # body bytes would desynchronize HTTP/1.1 keep-alive connections
            length = int(self.headers.get("Content-Length", 0))
            raw_body = self.rfile.read(length) if length else b""
            if self._route != Endpoint.PREPARE_PHASE:
                self._error(f"unknown endpoint: {self._route}", 404)
                return
            q = self._query()
            master_proto = q.get("ProtocolVersion", "")
            if master_proto != PROTOCOL_VERSION:
                # exact-match gate (reference: HTTPService.cpp:201-213)
                self._error(
                    f"protocol version mismatch: master {master_proto!r} != "
                    f"service {PROTOCOL_VERSION!r} - "
                    "master and service versions must match")
                return
            wire_cfg = json.loads(raw_body or b"{}")
            with st.lock:
                info = st.prepare(wire_cfg)
            self._reply(200, {"BenchPathInfo": info})
        except ProgException as e:
            self._error(str(e))
        except Exception as e:
            LOGGER.error(f"preparephase failed: {e}")
            self._error(f"preparephase failed: {e}", 500)


class Service:
    """Service-mode entry (reference: HTTPService::startServer)."""

    def __init__(self, cfg: Config) -> None:
        self.cfg = cfg

    def run(self) -> int:
        port = self.cfg.service_port
        self._check_port_available(port)
        LOGGER.enable_err_history()
        if not self.cfg.service_in_foreground:
            self._daemonize(port)

        state = ServiceState(self.cfg)
        handler = type("BoundHandler", (_Handler,), {})
        server = ThreadingHTTPServer(("0.0.0.0", port), handler)
        handler.state = state
        handler.server_obj = server
        LOGGER.info(f"elbencho-tpu service listening on port {port}")

        # The CLI's early-interrupt latch swallows the first SIGINT/SIGTERM
        # (it only records it), so serve_forever() would never see a
        # KeyboardInterrupt. Install our own handlers: first signal stops the
        # server from a helper thread (shutdown() must not run on the
        # serving thread), second one hard-exits.
        import signal

        interrupted = threading.Event()

        def _stop_handler(signum, frame):
            if interrupted.is_set():
                os._exit(130)
            interrupted.set()
            threading.Thread(target=server.shutdown, daemon=True).start()

        try:
            signal.signal(signal.SIGINT, _stop_handler)
            signal.signal(signal.SIGTERM, _stop_handler)
        except ValueError:
            pass  # not the main thread (tests drive run() directly)

        # a Ctrl-C during startup was latched rather than raised; honor it
        from .utils.signals import early_interrupt_pending

        if early_interrupt_pending():
            state.teardown_group()
            server.server_close()
            return 130

        try:
            server.serve_forever()
        except KeyboardInterrupt:
            interrupted.set()
        finally:
            state.teardown_group()
            server.server_close()
        return 130 if interrupted.is_set() else 0

    @staticmethod
    def _check_port_available(port: int) -> None:
        """(reference: checkPortAvailable, HTTPService.cpp:490-547)"""
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        try:
            s.bind(("0.0.0.0", port))
        except OSError:
            raise ProgException(
                f"service port {port} is already in use "
                "(another service instance running?)")
        finally:
            s.close()

    def _daemonize(self, port: int) -> None:
        """Fork into the background with a locked logfile
        (reference: HTTPService.cpp:371-482)."""
        logpath = os.path.join(
            tempfile.gettempdir(),
            f"elbencho_tpu_torch_{getpass.getuser()}_p{port}.log")
        logfh = open(logpath, "a")
        try:
            fcntl.flock(logfh, fcntl.LOCK_EX | fcntl.LOCK_NB)
        except OSError:
            raise ProgException(
                f"another service instance holds {logpath} - "
                "is a service already running on this port?")
        if os.fork() > 0:
            os._exit(0)
        os.setsid()
        if os.fork() > 0:
            os._exit(0)
        os.dup2(logfh.fileno(), sys.stdout.fileno())
        os.dup2(logfh.fileno(), sys.stderr.fileno())
        devnull = os.open(os.devnull, os.O_RDONLY)
        os.dup2(devnull, sys.stdin.fileno())
        LOGGER.stream = sys.stderr
