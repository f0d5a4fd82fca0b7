"""Streaming byte and line access over remote objects (counterpart of
ofasys_tpu/io/reader/streaming.py).

Records split on b'\\n' over any file-like ``read(n) -> bytes`` source (an
object-store body, an http response, a local file handle), with the reads
moved to a bounded background thread: the producer reads fixed chunks into
a queue ahead of the consumer, so a remote source's latency overlaps with
preprocessing instead of stalling it.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional

_SENTINEL = b""


class PrefetchByteStream:
    """Background-prefetched view of a byte source.

    A daemon thread reads ``chunk_bytes`` blocks into a queue at most
    ``max_chunks`` deep. ``read(n)`` drains it; EOF is an empty bytes
    sentinel. An error raised by the source is raised again on the consumer
    thread, at the read that reaches it.

    ``close()`` cancels the producer (it checks a flag around every bounded
    ``put``, so it never blocks forever on an abandoned stream) and closes
    the source; a context manager and ``__del__`` call it too, so a consumer
    that stops early leaks neither the thread nor the connection.
    """

    def __init__(self, source, chunk_bytes: int = 1 << 16, max_chunks: int = 16):
        self._source = source
        self._chunk = chunk_bytes
        self._q: "queue.Queue" = queue.Queue(maxsize=max_chunks)
        self._err: Optional[BaseException] = None
        self._leftover = b""
        self._eof = False
        self._cancelled = threading.Event()
        self._thread = threading.Thread(target=self._produce, daemon=True)
        self._thread.start()

    def _put(self, data: bytes) -> bool:
        """A bounded put that gives up once close() cancelled the stream."""
        while not self._cancelled.is_set():
            try:
                self._q.put(data, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _produce(self):
        try:
            while not self._cancelled.is_set():
                data = self._source.read(self._chunk)
                if not data or not self._put(data):
                    break
        except BaseException as e:          # noqa: BLE001 — raised again on the consumer
            self._err = e
        finally:
            # the sentinel must reach the consumer unless close() cancelled
            # the stream (close adds its own after draining)
            self._put(_SENTINEL)

    def read(self, n: int = -1) -> bytes:
        """Up to ``n`` bytes (all remaining if n < 0); b'' at EOF."""
        parts = [self._leftover] if self._leftover else []
        have = len(self._leftover)
        self._leftover = b""
        while not self._eof and (n < 0 or have < n):
            data = self._q.get()
            if data == _SENTINEL:
                self._eof = True
                if self._err is not None:
                    raise self._err
                break
            parts.append(data)
            have += len(data)
        buf = b"".join(parts)
        if 0 <= n < len(buf):
            self._leftover = buf[n:]
            buf = buf[:n]
        return buf

    def close(self):
        """Cancel the producer and close the source (idempotent)."""
        if self._cancelled.is_set():
            return
        self._cancelled.set()
        # drain, so a producer blocked in put() sees the flag promptly
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=1.0)
        self._eof = True
        try:   # reads after close() end at once
            self._q.put_nowait(_SENTINEL)
        except queue.Full:
            pass
        close = getattr(self._source, "close", None)
        if close is not None:
            try:
                close()
            except Exception:
                pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class StreamingLineReader:
    """Line records over a (prefetched) byte stream: records split on b'\\n'
    (the terminator consumed), an unterminated final line yielded last,
    ``readn`` returning exact byte counts (short only at EOF)."""

    def __init__(self, source, chunk_bytes: int = 1 << 16, max_chunks: int = 16,
                 prefetch: bool = True):
        self._s = PrefetchByteStream(source, chunk_bytes, max_chunks) if prefetch else source
        self._chunk = chunk_bytes
        self._buf = b""
        self._eof = False

    def _fill(self) -> bool:
        data = self._s.read(self._chunk)
        if not data:
            self._eof = True
            return False
        self._buf += data
        return True

    def close(self):
        close = getattr(self._s, "close", None)
        if close is not None:
            close()
        self._eof = True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def readline(self) -> Optional[bytes]:
        """The next line without its terminator; None past the last record
        (so an empty final record, as in b"a\\n\\n", differs from the end)."""
        while True:
            i = self._buf.find(b"\n")
            if i >= 0:
                line, self._buf = self._buf[:i], self._buf[i + 1:]
                return line
            if self._eof or not self._fill():
                if not self._buf:
                    return None
                tail, self._buf = self._buf, b""
                return tail

    def readn(self, n: int) -> bytes:
        while len(self._buf) < n and not self._eof:
            self._fill()
        out, self._buf = self._buf[:n], self._buf[n:]
        return out

    def __iter__(self) -> Iterator[bytes]:
        while True:
            line = self.readline()
            if line is None:
                return
            yield line
