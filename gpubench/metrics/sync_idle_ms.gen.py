"""Device-idle milliseconds a generate call after the program's host reads
(each ``kmb:sync.*`` range's end to the next device op; harness/program.py)."""

from gpubench.harness import program


def read(run):
    spans = program.spans(run)
    call = spans.get("generate")
    if not call or not call["calls"]:
        return None
    idle = sum(s["idle_after_s"] for name, s in spans.items() if name.startswith("sync."))
    return 1e3 * idle / call["calls"]
