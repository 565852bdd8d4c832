"""Traffic `simulate_mesh_calls`: whole `simulate(mesh=)` calls, one process
a card.

The ranks of a ('scen', 'body') mesh (`mesh`, e.g. {"scen": 1, "body":
4}): rank 0 is this process, on card 0; ranks 1 and up are worker
processes that set-up starts with the 'spawn' method, one a card, kept
for the whole run. Each rank sees the environment that `torchrun
--nproc-per-node <ranks>` would give it (RANK, WORLD_SIZE, LOCAL_RANK,
MASTER_ADDR 127.0.0.1, MASTER_PORT a free port), so that
`nbody_tpu_torch.parallel.mesh.make_mesh` opens the process group (NCCL on
cards, gloo on the CPU) through its launcher path, as a user's run does.
Every rank draws the same Plummer sphere from the seed
(`reference/scenes.plummer_scene`).

A request is one whole call of `simulate(scene, cfg, n_steps=...,
chunk=..., mesh=mesh)` from the initial state: rank 0 tells the workers
to start, runs its own call, and waits for every worker's answer; rank
0's final state is kept.

No wait is unbounded. A phase (set-up, a request, the stop) has a
deadline: set-up and the first request, which builds the kernel library
and captures the first graphs, `setup_timeout_s`; every later request
`timeout_s`. A guard thread watches the phase: when a worker dies or the
deadline passes, it kills the workers, so that a collective of rank 0
that waits for them raises (gloo), and the phase raises; if rank 0 is
still held after a grace of GRACE_S seconds (an NCCL collective waits
for its peers for ever), the process ends with exit code 1 rather than
hang. After a failed phase the mesh is down and every later request
raises.

Each worker refuses to run (its phase raises) if a module of jax,
jaxlib, flax or nbody_tpu is loaded in it: the harness's rule
(`benchmark/run.py`), which the harness cannot check in the ranks it does
not see.

Parameters (the cell's `traffic`): `n`, `n_steps`, `chunk`, `mesh`,
`timeout_s`, `setup_timeout_s`. The configuration gives `precision`,
`integrator`, `compensated` and the constants.

The check stops the workers and closes the process group, so that the
cards are free, then marches the split reference
(`reference/plummer_cards.py`) over the cards the ranks had, and holds
every call's final (q, v) to it: `plummer.gaps` on each body rank's
block of rows, the widest over the blocks (`gaps`), so that one rank's
wrong rows fail the median of `v_med_gap`, which a median over all n
bodies, three quarters of them right, would pass. The work reported is
rank 0's share of a call: its rows against all n sources a step.
"""

from __future__ import annotations

import contextlib
import importlib
import os
import socket
import sys
import threading
import time
import traceback

import numpy as np
import torch

from benchmark.reference import plummer, plummer_cards, scenes

GRACE_S = 10.0              # a guard's wait for rank 0 after the kill
ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


class MeshDown(RuntimeError):
    """A worker died or did not answer in time: the mesh is down."""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def gaps(finals: list, ref: tuple, q0: np.ndarray, v0: np.ndarray,
         ni: int) -> dict:
    """`plummer.gaps` of each block of ni rows (a body rank's), the widest
    over the blocks."""
    out = {}
    for a in range(0, len(q0), ni):
        rows = slice(a, a + ni)
        each = plummer.gaps([(q[rows], v[rows]) for q, v in finals],
                            (ref[0][rows], ref[1][rows]), q0[rows],
                            v0[rows])
        for k, x in each.items():
            out[k] = max(out.get(k, 0.0), x)
    return out


class _Rank:
    """One rank's part: the mesh, opened from the environment, the sphere
    drawn from the seed, and its simulate() call."""

    def __init__(self, cell: dict, config: dict, seed: int, device: str):
        from nbody_tpu_torch.config import SimConfig
        from nbody_tpu_torch.io import Scene
        from nbody_tpu_torch.parallel.mesh import make_mesh

        t, c = cell["traffic"], config["constants"]
        n = t["n"]
        self.q, self.v, self.m = scenes.plummer_scene(
            n, seed=seed, total_mass=c["total_mass"],
            scale_radius=c["scale_radius"], G=c["G"])
        self.scene = Scene(n=n, planet=0, asteroid=1, q=self.q, v=self.v,
                           m=self.m, types=["star"] * n,
                           device_idx=np.zeros(0, np.int64))
        self.cfg = SimConfig(G=c["G"], eps=c["eps"], dt=c["dt"])
        self.mesh = make_mesh(t["mesh"], device)
        self.kw = {"n_steps": t["n_steps"], "chunk": t["chunk"],
                   "precision": config["precision"],
                   "integrator": config["integrator"],
                   "compensated": config["compensated"], "mesh": self.mesh}
        # the module's attribute at set-up (the package's `simulate` is
        # the function)
        self._simulate = importlib.import_module(
            "nbody_tpu_torch.simulate").simulate
        self.cuda = device == "cuda"

    def call(self, compensated: bool | None = None):
        """The call; `compensated` other than None in place of the
        configuration's (the control's uncompensated call)."""
        kw = self.kw if compensated is None else \
            dict(self.kw, compensated=compensated)
        st = self._simulate(self.scene, self.cfg, **kw)
        if self.cuda:
            torch.cuda.synchronize()
        return st


def _close_group() -> None:
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


def _refuse_forbidden() -> None:
    from benchmark.run import forbidden_modules

    found = forbidden_modules(sys.modules)
    if found:
        raise RuntimeError("modules of jax or the JAX package were loaded "
                           f"in rank {os.environ['RANK']}: "
                           + ", ".join(found))


def _orphan_watch(parent: int) -> None:
    """End this worker when the process that started it is gone."""
    def watch():
        while os.getppid() == parent:
            time.sleep(1.0)
        os._exit(1)
    threading.Thread(target=watch, daemon=True).start()


def worker_main(rank: int, env: dict, cell: dict, config: dict, seed: int,
                device: str, conn, parent: int) -> None:
    """A worker rank: set-up, then one call for each ('call', compensated)
    received, until ('stop', None). Answers 'ready', 'done' and
    'stopped', or ('failed', its traceback) and ends.

    At the stop it ends at once, its process group left to the process's
    end: NCCL's teardown in `destroy_process_group` waits for every rank,
    and rank 0 waits for the answers first (on four H100s each worker's
    teardown outlasted the stop's 60 s deadline, every run). Rank 0 closes
    its own group once the workers are gone (`Traffic.close`)."""
    _orphan_watch(parent)
    os.environ.update(env, RANK=str(rank), LOCAL_RANK=str(rank))
    if device == "cpu":
        torch.set_num_threads(1)
    try:
        me = _Rank(cell, config, seed, device)
        _refuse_forbidden()
        conn.send(("ready", None))
        while (msg := conn.recv())[0] == "call":
            me.call(msg[1])
            _refuse_forbidden()
            conn.send(("done", None))
        conn.send(("stopped", None))
        sys.stderr.flush()
        os._exit(0)
    except Exception:
        text = traceback.format_exc()
        print(f"rank {rank} failed:\n{text}", file=sys.stderr, flush=True)
        with contextlib.suppress(OSError):
            conn.send(("failed", text))


class Traffic:
    def __init__(self, cell: dict, config: dict, seed: int, device: str):
        t, c = cell["traffic"], config["constants"]
        self.n, self.n_steps, self.c = t["n"], t["n_steps"], c
        self.timeout, self.setup_timeout = t["timeout_s"], \
            t["setup_timeout_s"]
        world = int(np.prod(list(t["mesh"].values())))
        self.ni = -(-self.n // t["mesh"].get("body", 1))
        self.devices = [f"cuda:{r}" if device == "cuda" else "cpu"
                        for r in range(world)]
        self.finals, self.workers = [], []
        self.down = None            # why the mesh is down, once it is
        self.closed = False
        self._env = {k: os.environ.get(k) for k in ENV}
        env = {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(_free_port()),
               "WORLD_SIZE": str(world)}
        # the worker by its import path (spawn pickles it by name)
        target = importlib.import_module(__name__).worker_main
        ctx = torch.multiprocessing.get_context("spawn")
        for rank in range(1, world):
            mine, theirs = ctx.Pipe()
            p = ctx.Process(target=target, name=f"mesh-rank-{rank}",
                            args=(rank, env, cell, config, seed, device,
                                  theirs, os.getpid()),
                            daemon=True)
            p.start()
            theirs.close()
            self.workers.append((p, mine))
        os.environ.update(env, RANK="0", LOCAL_RANK="0")
        try:
            with self._phase("set-up", self.setup_timeout):
                self.rank = _Rank(cell, config, seed, device)
                self._answers("ready")
        except MeshDown:
            self.close()
            raise
        self.q, self.v, self.m = self.rank.q, self.rank.v, self.rank.m
        from nbody_tpu_torch.ops.graded_step import GRAPHS
        self._graphs = GRAPHS

    # -- the phases and their guard ---------------------------------------

    @contextlib.contextmanager
    def _phase(self, what: str, seconds: float, exits: bool = False):
        """A phase of rank 0 under a guard (module docstring); any failure
        inside it leaves the mesh down and raises. `exits`: the workers end
        in this phase, so only its deadline is watched."""
        if self.down:
            time.sleep(1.0)         # a failed window prints a line a second
            raise MeshDown(self.down)
        done = threading.Event()
        guard = threading.Thread(target=self._guard,
                                 args=(what, seconds, exits, done),
                                 daemon=True)
        guard.start()
        try:
            yield
        except Exception as e:
            self.down = self.down or f"{what}: {e!r}"
            self._kill()
            raise MeshDown(self.down) from e
        finally:
            done.set()
            guard.join()

    def _guard(self, what: str, seconds: float, exits: bool, done) -> None:
        end = time.monotonic() + seconds
        while not done.wait(0.2):
            dead = [] if exits else [(r, p.exitcode) for r, (p, _) in
                                     enumerate(self.workers, 1)
                                     if not p.is_alive()]
            if dead:
                reason = f"{what}: rank {dead[0][0]} exited with code " \
                         f"{dead[0][1]}"
            elif time.monotonic() > end:
                reason = f"{what}: no answer within {seconds} s"
            else:
                continue
            self.down = reason
            print(f"mesh down, {reason}", file=sys.stderr, flush=True)
            self._kill()
            if not done.wait(GRACE_S):
                # a collective of rank 0 (NCCL's) that waits for the
                # killed ranks for ever: nothing else can end it
                print(f"{what}: rank 0 still held {GRACE_S} s after the "
                      "workers were stopped; the run ends here",
                      file=sys.stderr, flush=True)
                os._exit(1)
            return

    def _answers(self, what: str) -> None:
        """Every worker's next answer, which must be `what`. A worker that
        dies closes its end of the pipe, so recv raises EOFError."""
        for rank, (_, conn) in enumerate(self.workers, 1):
            kind, text = conn.recv()
            if kind != what:
                raise MeshDown(f"rank {rank} answered {kind!r} for "
                               f"{what!r}:\n{text}")

    def _kill(self) -> None:
        for p, _ in self.workers:
            if p.is_alive():
                p.kill()
        for p, _ in self.workers:
            p.join(5.0)

    def close(self) -> None:
        """Stop the workers, then close rank 0's process group (the cards
        free), once; the environment as it was. A teardown of rank 0 that
        does not return within `timeout_s` is left behind in its thread:
        the check that follows needs no process group."""
        if self.closed:
            return
        self.closed = True
        try:
            if not self.down:
                with contextlib.suppress(MeshDown), \
                        self._phase("stop", self.timeout, exits=True):
                    for _, conn in self.workers:
                        conn.send(("stop", None))
                    self._answers("stopped")
                    for p, _ in self.workers:
                        p.join(self.timeout)
        finally:
            self._kill()
            closing = threading.Thread(target=_close_group, daemon=True)
            closing.start()
            closing.join(self.timeout)
            if closing.is_alive():
                print(f"rank 0's process group did not close within "
                      f"{self.timeout} s; left open", file=sys.stderr,
                      flush=True)
            for k, v in self._env.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v

    # -- the driver's interface -------------------------------------------

    def request(self, tag: str, compensated: bool | None = None) -> None:
        """One simulate() call on every rank from the initial state
        (`compensated` as `_Rank.call` has it)."""
        seconds = self.timeout if self.finals else self.setup_timeout
        with self._phase(f"request {tag}", seconds):
            for _, conn in self.workers:
                conn.send(("call", compensated))
            st = self.rank.call(compensated)
            self._answers("done")
        self.finals.append((st.q, st.v))

    def counters(self) -> dict:
        g = self._graphs
        return {"graph_replays": g.replays, "graph_captures": g.captures,
                "graph_capture_s": g.capture_s}

    def end_to_end(self, window_s: float, completed: int) -> dict:
        pairs = self.n * self.n * self.n_steps * completed
        return {"sim_pairs_per_s": pairs / window_s}

    def reference(self, dtype: torch.dtype = torch.float64) -> tuple:
        """The split reference from the initial state, over the ranks'
        cards (the workers stopped first)."""
        self.close()
        c = self.c
        return plummer_cards.march(self.q, self.v, self.m,
                                   n_steps=self.n_steps, G=c["G"],
                                   eps=c["eps"], dt=c["dt"],
                                   devices=self.devices, dtype=dtype)

    def check(self) -> tuple[dict, dict]:
        """(the numbers compared, rank 0's work in one request)."""
        ref = self.reference()
        return (gaps(self.finals, ref, self.q, self.v, self.ni),
                {"pairs": self.ni * self.n * self.n_steps,
                 "precision": "f32"})


def control(cell: dict, config: dict, seed: int, device: str) -> dict:
    """The control's numbers for one seed: the split reference marched in
    bfloat16 (the precision below the configuration's float32), judged
    as a call's final state is; beside it the program's own
    uncompensated float32 call on the mesh, a second witness; and last
    the program's call as the cell makes it ('program': no control, the
    sound reading of the same seed, which the limits lie above)."""
    t = Traffic(cell, config, seed, device)
    try:
        t.request("sound")
        t.request("plain", compensated=False)
    finally:
        t.close()
    ref = t.reference()
    low = t.reference(torch.bfloat16)
    sound, plain = t.finals
    return {"bf16": gaps([low], ref, t.q, t.v, t.ni),
            "program_uncompensated": gaps([plain], ref, t.q, t.v, t.ni),
            "program": gaps([sound], ref, t.q, t.v, t.ni)}
