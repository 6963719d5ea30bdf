"""Device ms of the host-to-device copies a request: every ``Memcpy HtoD``
in the traced window over the requests answered there."""
from portbench import stats


def read(records, cfg):
    copies = [e for e in stats.window_events(records)
              if e[0] == "gpu_memcpy" and "HtoD" in e[1]]
    answered = sum(1 for r in records["requests"] if r[3])
    if not copies or not answered:
        return None
    return sum(e[3] for e in copies) * 1e-3 / answered
