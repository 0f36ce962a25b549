"""Raw, aligned array files: a header, then arrays at 64-byte-aligned
offsets, written atomically and loaded as read-only views of a memory
map, so a load copies nothing and each page faults in where it is first
read. The sorted-key sidecar (``io/kmc.py``) and the reference k-mer
index (``engine/refindex.py``) are such files; each owns its header."""

import contextlib
import mmap
import os

ALIGN = 64


def layout(head, sizes):
    """Byte offsets of arrays of ``sizes`` bytes laid out in order after
    a ``head``-byte header, each at a 64-byte-aligned offset, and the
    file's total length (the last array's end)."""
    offs, end = [], head
    for size in sizes:
        off = -(-end // ALIGN) * ALIGN
        offs.append(off)
        end = off + size
    return offs, end


def write(path, head, offs, total, arrays):
    """``head`` and each contiguous array at its offset, written into a
    temporary file that is then renamed over ``path``: a concurrent
    reader never sees a truncated file and two writers never interleave.
    Raises OSError, after removing the temporary file."""
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        with open(tmp, "wb") as fh:
            fh.write(head)
            for off, a in zip(offs, arrays):
                fh.seek(off)
                fh.write(a)
            fh.truncate(total)  # pads out trailing empty arrays
        os.replace(tmp, path)
    except BaseException:
        with contextlib.suppress(OSError):
            os.unlink(tmp)
        raise


def map_readonly(fh):
    """A read-only memory map of the whole open file ``fh``; arrays
    viewed on it with ``np.frombuffer`` are read-only."""
    return mmap.mmap(fh.fileno(), 0, access=mmap.ACCESS_READ)
