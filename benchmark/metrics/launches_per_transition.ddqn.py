"""Kernel launches in a profiled stretch of env batches over the
transitions pushed to the replay in it (a count a transition)."""


def read(record: dict):
    trace = record.get("trace")
    if not trace or not trace.get("transitions"):
        return None
    return sum(trace["launches"].values()) / trace["transitions"]
