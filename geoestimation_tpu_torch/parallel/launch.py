"""A world of ranks on one host: the launcher of the port's multi-process
CPU tests, `chip_smoke.py`'s rank groups and `tools.train_roofline
--collectives`.

`Ranks(n, limit_s)` binds the rendezvous store itself, a `TCPStore` on a
port the operating system picks, and holds it until the world is closed:
no other process can take the port between its choice and the ranks'
rendezvous. A rank started here finds the store's address in its
environment (`STORE_ENV`), and `multihost.initialize` then joins through
`meet`: it connects to the store and waits there until every rank of the
world has connected, each having imported what it runs, before
`init_process_group` starts the rendezvous clock (`timeout_s`, 30 s in the
tests). So a rank that is still importing on a loaded host cannot make a
peer miss the rendezvous; the world's own `limit_s`, counted from its
start, ends a world whose rank hangs or never comes.

Two kinds of rank:

  * `start(fn, *args)`: fn(rank, n, *args) in n processes forked from a
    forkserver, a fresh single-threaded process that has imported torch
    and the port's training modules once (`PRELOAD`); each rank joins the
    group on the CPU (gloo, one torch thread) before fn and leaves it
    after. fn is pickled by its module's name, so it is not defined in
    `__main__`. A rank's traceback comes back through the store.
  * `popen(argv)`: argv(rank) as n commands, each with the coordinator
    flags of its rank (none in a world of one) and its output piped; the
    port's CLIs join through `multihost.maybe_initialize`.

`wait()` returns each rank's exit code and output, and kills the world and
raises TimeoutError at its limit. `close_all()` kills every rank of this
process's worlds that still runs (at interpreter exit too).
"""

from __future__ import annotations

import atexit
import datetime
import os
import subprocess
import sys
import time
import traceback
import weakref

import torch
import torch.distributed as dist

STORE_ENV = "GEOESTIMATION_RANKS_STORE"
# imported once by the forkserver, so that no function rank imports them
PRELOAD = ("numpy", "torch", "geoestimation_tpu_torch.parallel.multihost",
           "geoestimation_tpu_torch.parallel.mesh",
           "geoestimation_tpu_torch.checkpoint",
           "geoestimation_tpu_torch.convert",
           "geoestimation_tpu_torch.train.step",
           "geoestimation_tpu_torch.tools.world")
_READY, _ALL_READY, _ERROR = "launch/ready", "launch/all_ready", "launch/error"
# the wait for the world's last rank; the launcher's limit ends it sooner
_READY_WAIT = datetime.timedelta(hours=1)

_worlds = weakref.WeakSet()     # for `close_all`


def meet(address: str, n: int, timeout: datetime.timedelta):
    """The store of a launched rank: a client of the launcher's, returned
    once all n ranks of the world have connected."""
    host, port = address.rsplit(":", 1)
    store = dist.TCPStore(host, int(port), n, is_master=False,
                          timeout=timeout)
    if store.add(_READY, 1) == n:
        store.set(_ALL_READY, "1")
    store.wait([_ALL_READY], _READY_WAIT)
    return store


def _function_rank(fn, rank, n, address, env, cwd, timeout_s, args):
    # the forkserver holds the environment and directory of its own start
    os.environ.clear()
    os.environ.update(env)
    os.chdir(cwd)
    torch.set_num_threads(1)
    # TensorBoard's import would import TensorFlow, where it is installed
    sys.modules["torch.utils.tensorboard"] = None
    from . import multihost

    try:
        multihost.initialize(address, n, rank, cpu=True, timeout_s=timeout_s)
        fn(rank, n, *args)
    except BaseException:
        host, port = address.rsplit(":", 1)
        dist.TCPStore(host, int(port), n, is_master=False).set(
            f"{_ERROR}/{rank}", traceback.format_exc())
        raise
    finally:
        multihost.shutdown()


class Ranks:
    """n ranks on this host and the store they meet at; the world ends at
    `limit_s` seconds from its start."""

    def __init__(self, n: int, limit_s: float):
        self.n, self.limit_s = n, limit_s
        self._store = dist.TCPStore("127.0.0.1", 0, n, is_master=True,
                                    wait_for_workers=False)
        self.address = f"127.0.0.1:{self._store.port}"
        self._deadline = time.monotonic() + limit_s
        self._procs = []
        _worlds.add(self)

    def flags(self, rank: int) -> list:
        """The coordinator flags of a command-line rank (none alone)."""
        if self.n == 1:
            return []
        return ["--coordinator", self.address, "--num_processes",
                str(self.n), "--process_id", str(rank)]

    def popen(self, argv, env=None, **kw) -> "Ranks":
        """Starts argv(rank) + flags(rank) for each rank, stdout and stderr
        piped together as text."""
        env = {**(os.environ if env is None else env),
               STORE_ENV: self.address}
        self._procs = [subprocess.Popen(
            argv(r) + self.flags(r), env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, **kw) for r in range(self.n)]
        return self

    def start(self, fn, *args, timeout_s: float = 30.0) -> "Ranks":
        """Starts fn(rank, n, *args) in n forked ranks, each in the group
        on the CPU (collectives wait at most `timeout_s`) on one torch
        thread."""
        ctx = torch.multiprocessing.get_context("forkserver")
        ctx.set_forkserver_preload(list(PRELOAD))
        env = {**os.environ, STORE_ENV: self.address}
        self._procs = [ctx.Process(target=_function_rank, args=(
            fn, r, self.n, self.address, env, os.getcwd(), timeout_s, args))
            for r in range(self.n)]
        for p in self._procs:
            p.start()
        return self

    def wait(self) -> list:
        """(exit code, output) of each rank once all have ended: a command's
        output, or a function rank's traceback ("" if it passed). At the
        world's limit, kills every rank and raises TimeoutError."""
        outs = []
        for p in self._procs:
            left = max(0.1, self._deadline - time.monotonic())
            if isinstance(p, subprocess.Popen):
                try:
                    outs.append(p.communicate(timeout=left)[0])
                except subprocess.TimeoutExpired:
                    self._timed_out()
                continue
            p.join(left)
            if p.is_alive():
                self._timed_out()
            outs.append(None)
        codes = [p.returncode if isinstance(p, subprocess.Popen)
                 else p.exitcode for p in self._procs]
        for r, out in enumerate(outs):
            if out is None:
                key = f"{_ERROR}/{r}"
                outs[r] = (self._store.get(key).decode()
                           if self._store.check([key]) else
                           "" if codes[r] == 0 else "(no traceback)")
        return list(zip(codes, outs))

    def _timed_out(self):
        self.close()
        raise TimeoutError(f"a rank of {self.n} passed the world's "
                           f"{self.limit_s} s limit")

    def close(self):
        """Kills the ranks that still run."""
        for p in self._procs:
            if isinstance(p, subprocess.Popen):
                if p.poll() is None:
                    p.kill()
                    p.communicate()
            elif p.is_alive():
                p.kill()
                p.join()


def close_all():
    for world in list(_worlds):
        world.close()


atexit.register(close_all)
