"""Sweeps over several ranks of ``torch.distributed`` (counterpart of
``cedarsim_tpu/parallel/``): ``mesh.py`` shards a DC or transient sweep
over a process group's ranks, :class:`RankPool` starts the ranks as child
processes and calls functions on all of them, and
:func:`dryrun_multichip` runs the sharded gates of ``dryrun_child.py`` on
``n`` ranks (the counterpart of ``__graft_entry__.dryrun_multichip``).

The children join their group through a ``file://`` rendezvous in the
temporary directory, so no rank opens a network socket to find another.
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile

import torch

from cedarsim_tpu_torch.parallel.worker import read_msg, write_msg

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _rendezvous():
    """(``file://`` URL, path) of a fresh rendezvous for
    ``init_process_group``: a path in the temporary directory that does not
    exist yet.  The caller removes it once its ranks have ended."""
    fd, path = tempfile.mkstemp(prefix="cedarsim_mesh_")
    os.close(fd)
    os.unlink(path)
    return "file://" + path, path


def _remove(path):
    try:
        os.unlink(path)
    except FileNotFoundError:
        pass


def rank_backend(n_ranks, device=None, backend=None):
    """(device, backend) of ``n_ranks`` child ranks: the CUDA card by
    default (NCCL while every rank has a card of its own, else gloo, which
    lets ranks share a card), gloo for ``device="cpu"``.  A card asked for
    without one raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"{n_ranks} CUDA ranks asked for and this process sees no "
                "CUDA card; pass device='cpu' for gloo ranks on the host")
        backend = backend or ("nccl" if n_ranks <= torch.cuda.device_count()
                              else "gloo")
    else:
        backend = backend or "gloo"
    return str(dev), backend


def _rank_env(n, rank, init, threads=None):
    env = dict(os.environ)
    env.update(RANK=str(rank), WORLD_SIZE=str(n), LOCAL_RANK=str(rank),
               CEDARSIM_MESH_INIT=init)
    env["PYTHONPATH"] = _ROOT + os.pathsep + env.get("PYTHONPATH", "")
    if threads is not None:
        env["OMP_NUM_THREADS"] = env["MKL_NUM_THREADS"] = str(threads)
    return env


class RankPool:
    """``n`` ranks of one process group, each a child process
    (``parallel/worker.py``) that joins the group once and then runs the
    calls it is sent: ``pool.call(fn, *args, **kw)`` runs ``fn`` (a
    module-level function, pickled by reference) on every rank at once
    and returns the ranks' results in rank order.  ``device``/``backend``
    as :func:`rank_backend`; ``threads`` sets each rank's intra-op thread
    count.  Use it as a context manager, or call :meth:`close`: every
    child is stopped."""

    def __init__(self, n, device=None, backend=None, threads=None):
        self.size = int(n)
        self.device, self.backend = rank_backend(n, device, backend)
        init, self._store = _rendezvous()
        self.procs = [
            subprocess.Popen(
                [sys.executable, "-m", "cedarsim_tpu_torch.parallel.worker",
                 self.device, self.backend],
                stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                env=_rank_env(n, r, init, threads), cwd=_ROOT)
            for r in range(self.size)]
        try:
            self._collect("join the process group")
        except BaseException:
            self.close()
            raise

    def _collect(self, what):
        out, errs = [], []
        for r, p in enumerate(self.procs):
            msg = read_msg(p.stdout)
            if msg is None:
                errs.append(f"rank {r} ended (rc={p.poll()})")
            elif msg[0] == "err":
                errs.append(f"rank {r}:\n{msg[1]}")
            else:
                out.append(msg[1])
        if errs:
            raise RuntimeError(f"RankPool: could not {what}:\n"
                               + "\n".join(errs))
        return out

    def call(self, fn, *args, **kw):
        """``fn(*args, **kw)`` on every rank; the results in rank order."""
        for p in self.procs:
            write_msg(p.stdin, (fn, args, kw))
        return self._collect(f"run {getattr(fn, '__name__', fn)}")

    def close(self, timeout=30):
        for p in self.procs:
            if p.stdin and not p.stdin.closed:
                try:
                    p.stdin.close()
                except OSError:
                    pass
        for p in self.procs:
            try:
                p.wait(timeout=timeout)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
            if p.stdout:
                p.stdout.close()
        self.procs = []
        _remove(self._store)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def dryrun_multichip(n_devices: int, device=None, timeout=1800) -> str:
    """Run ``dryrun_child.py``'s gates on ``n_devices`` ranks, each
    ``python -m cedarsim_tpu_torch.parallel.dryrun_child n`` in a process
    of its own: on the CUDA card by default (no card raises), as gloo
    ranks on the host with ``device="cpu"``.  Prints and returns rank 0's
    summary line; raises when a rank fails."""
    dev, backend = rank_backend(n_devices, device)
    init, store = _rendezvous()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "cedarsim_tpu_torch.parallel.dryrun_child",
         str(n_devices), dev, backend],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=_rank_env(n_devices, r, init), cwd=_ROOT)
        for r in range(n_devices)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        _remove(store)
    bad = [(r, p.returncode, err) for r, (p, (_, err))
           in enumerate(zip(procs, outs)) if p.returncode != 0]
    if bad:
        raise RuntimeError("dryrun_multichip: " + "; ".join(
            f"rank {r} failed (rc={rc}):\n{err[-2000:]}"
            for r, rc, err in bad))
    line = outs[0][0].strip().splitlines()[-1]
    print(line)
    return line
