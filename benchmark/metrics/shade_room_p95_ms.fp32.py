"""shade_room_p95_ms in the fp32 cell, where the window holds too few
rooms for the tail to decide a change: 95th percentile, over every room
of the window, of a room's latency (render start to images on the host)."""
from benchmark.harness import percentile


def read(rec):
    lat = rec.get("room_ms")
    return percentile(lat, 95.0) if lat else None
