"""% of extra tokens patch attention takes over the points it attends:
(padded tokens - points) / points over every scale of the measured
window's steps, from the program's counters."""


def read(run):
    counts = run.counts.get("window")
    if not counts or not counts["points"]:
        return None
    pts = sum(counts["points"].values())
    return 100.0 * (sum(counts["padded"].values()) - pts) / pts
