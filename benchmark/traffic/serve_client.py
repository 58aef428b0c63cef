"""The open-loop load generator of the serving cells, in a process of its
own (started with ``subprocess``; it talks over its pipes):

1. reads the spec line (seed, rate, seconds, lengths, connections,
   timeout) and builds every request's ``pcm16`` JSON body from the seed;
2. prints ``ready``; reads the go line (host, port, the window's start on
   ``time.monotonic``);
3. sends request i at its due time, start + arrivals[i], from a pool of
   connections, whatever the replies before it; when every reply is in,
   prints one JSON line: per request (sent, done, status, probs or error)
   and how late the sends ran."""

import base64
import http.client
import json
import queue
import sys
import threading
import time
from pathlib import Path

sys.path[0] = str(Path(__file__).resolve().parents[2])

from benchmark.lib import corpus  # noqa: E402


def main() -> int:
    spec = json.loads(sys.stdin.readline())
    sched = corpus.serve_schedule(spec["seed"], spec["rate"], spec["seconds"], spec["lengths"])
    audio = corpus.serve_audio(spec["seed"])
    bodies = [json.dumps({"pcm16": base64.b64encode(
        audio[o:o + n].astype("<i2").tobytes()).decode(), "sr": corpus.SAMPLE_RATE}).encode()
        for o, n in zip(sched["offsets"].tolist(), sched["lengths"].tolist())]
    print("ready", flush=True)
    go = json.loads(sys.stdin.readline())
    host, port, t0, timeout = go["host"], go["port"], go["t0"], spec["timeout_s"]
    arrivals = sched["arrivals"].tolist()
    results = [None] * len(bodies)
    todo: "queue.Queue" = queue.Queue()

    def worker():
        while True:
            i = todo.get()
            if i is None:
                return
            sent = time.monotonic()
            try:
                conn = http.client.HTTPConnection(host, port, timeout=timeout)
                try:
                    conn.request("POST", "/predict", bodies[i],
                                 {"Content-Type": "application/json"})
                    r = conn.getresponse()
                    data = r.read()
                    status = r.status
                finally:
                    conn.close()
                done = time.monotonic()
                reply = json.loads(data)
                results[i] = [sent, done, status, reply.get("probs") if status == 200 else
                              str(reply.get("error"))]
            except (OSError, http.client.HTTPException, ValueError) as e:
                results[i] = [sent, time.monotonic(), -1, repr(e)]

    threads = [threading.Thread(target=worker, daemon=True) for _ in range(spec["connections"])]
    for t in threads:
        t.start()
    for i, a in enumerate(arrivals):
        wait = t0 + a - time.monotonic()
        if wait > 0:
            time.sleep(wait)
        todo.put(i)
    for _ in threads:
        todo.put(None)
    for t in threads:
        t.join(timeout + 60)
    late = sorted(r[0] - (t0 + a) for r, a in zip(results, arrivals) if r is not None)
    print(json.dumps({
        "results": results,
        "lateness_ms": {"p50": 1e3 * late[len(late) // 2] if late else None,
                        "p99": 1e3 * late[int(0.99 * (len(late) - 1))] if late else None,
                        "max": 1e3 * late[-1] if late else None},
    }), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
