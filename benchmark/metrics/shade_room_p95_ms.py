"""95th percentile, over every room of the window, of a room's latency
(start of its render until its images are on the host)."""

from benchmark.harness import percentile


def read(rec):
    lat = rec.get("room_ms")
    return percentile(lat, 95.0) if lat else None
