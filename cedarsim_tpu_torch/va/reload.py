"""Live-reloadable Verilog-A modules (counterpart of
``cedarsim_tpu/va/reload.py``): edit a ``.va`` file and its model classes
update without restarting the session, the role of the reference's Revise
integration.  The classes come from the port's own ``va/codegen.py::
load_va``; the watch (the file and the ``include``'d files found on the
search path, by modification time) is the JAX package's.
"""

from __future__ import annotations

import os
import re

from cedarsim_tpu_torch.va.codegen import load_va

_INCLUDE_RE = re.compile(r'`include\s+"([^"]+)"')


def _watched_files(path, include_paths):
    """The file plus any \\`include'd files resolvable on the search path."""
    files = [path]
    try:
        text = open(path).read()
    except OSError:
        return files
    dirs = [os.path.dirname(os.path.abspath(path)), *include_paths]
    for name in _INCLUDE_RE.findall(text):
        for d in dirs:
            cand = os.path.join(d, name)
            if os.path.exists(cand):
                files.append(cand)
                break
    return files


def load_va_file(path, include_paths=()):
    """Parse and compile a ``.va`` file: {module name: device class}."""
    with open(path) as f:
        text = f.read()
    paths = (os.path.dirname(os.path.abspath(path)), *include_paths)
    return load_va(text, file=os.path.basename(path), include_paths=paths)


class VAWatch:
    """Holds the compiled classes of a ``.va`` file and compiles them again
    when the file (or an include) changes on disk::

        w = VAWatch("myres.va")
        ckt.add(w.classes["myres"], ...)
        ...edit myres.va...
        if w.reload():          # True: the classes were compiled again
            rebuild_circuit(w.classes)
    """

    def __init__(self, path, include_paths=()):
        self.path = path
        self.include_paths = tuple(include_paths)
        self.classes = load_va_file(path, include_paths)
        self._mtimes = self._stat()

    def _stat(self):
        return {f: os.path.getmtime(f)
                for f in _watched_files(self.path, self.include_paths)
                if os.path.exists(f)}

    def changed(self) -> bool:
        return self._stat() != self._mtimes

    def reload(self) -> bool:
        """Compile again if anything changed; True when the classes were
        updated."""
        if not self.changed():
            return False
        self.classes = load_va_file(self.path, self.include_paths)
        self._mtimes = self._stat()
        return True
