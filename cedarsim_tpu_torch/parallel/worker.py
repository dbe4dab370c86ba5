"""One rank of a :class:`~cedarsim_tpu_torch.parallel.RankPool`.

``python -m cedarsim_tpu_torch.parallel.worker DEVICE BACKEND``, with
``RANK``, ``WORLD_SIZE`` and ``CEDARSIM_MESH_INIT`` in its environment:
joins the process group (``make_mesh``), then answers calls read from its
standard input, each a pickled (function, args, kwargs) with a
length prefix, with a pickled ("ok", result) or ("err", traceback) on
its standard output, until its input closes.  What the called code
prints goes to standard error.
"""

import os
import pickle
import struct
import sys
import traceback


def read_msg(f):
    head = f.read(8)
    if len(head) < 8:
        return None
    (n,) = struct.unpack("<Q", head)
    return pickle.loads(f.read(n))


def write_msg(f, obj):
    data = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    f.write(struct.pack("<Q", len(data)) + data)
    f.flush()


def main(device, backend):
    out = os.fdopen(os.dup(1), "wb")
    os.dup2(2, 1)
    sys.stdout = sys.stderr
    inp = os.fdopen(os.dup(0), "rb")
    from cedarsim_tpu_torch.parallel import mesh
    try:
        mesh._MESH = mesh.make_mesh(device=device, backend=backend)
    except Exception:
        write_msg(out, ("err", traceback.format_exc()))
        return 1
    write_msg(out, ("ok", mesh._MESH.rank))
    while True:
        msg = read_msg(inp)
        if msg is None:
            break
        fn, args, kw = msg
        try:
            write_msg(out, ("ok", fn(*args, **kw)))
        except Exception:
            write_msg(out, ("err", traceback.format_exc()))
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1], sys.argv[2]))
