"""The benchmark's client of the program's serving engine.

Each request gets a thread that blocks on the engine's output queue and
stamps every token with `time.monotonic()` as it arrives, so the latency
of a request is what a caller reading that queue sees. Requests are
greedy (temperature 0), as the output check needs.
"""

import threading
import time
from typing import Callable, List, Optional

from portbench.traffic import Request


class Client:
    def __init__(self, engine):
        self.engine = engine
        self.threads: List[threading.Thread] = []
        self.lock = threading.Lock()

    def submit(self, r: Request, on_done: Optional[Callable[[Request], None]] = None) -> None:
        r.t_submit = time.monotonic()
        try:
            out = self.engine.submit(r.prompt, r.max_new, temperature=0.0,
                                     request_id=r.index)
        except Exception as e:  # noqa: BLE001 - a refused request is a failed one
            r.error, r.t_done = repr(e), time.monotonic()
            return
        t = threading.Thread(target=self._consume, args=(r, out, on_done), daemon=True)
        with self.lock:
            self.threads.append(t)
        t.start()

    @staticmethod
    def _consume(r: Request, out, on_done) -> None:
        while True:
            item = out.get()
            now = time.monotonic()
            if item is None:
                r.t_done = now
                break
            if isinstance(item, BaseException):
                r.error, r.t_done = repr(item), now
                break
            r.tokens.append(int(item))
            r.times.append(now)
        if on_done is not None:
            on_done(r)

    def join(self, timeout: float = 30.0) -> None:
        deadline = time.monotonic() + timeout
        with self.lock:
            threads = list(self.threads)
        for t in threads:
            t.join(max(0.0, deadline - time.monotonic()))
