"""knn_ms_per_kf: host ms of descriptor-database work per keyframe fed:
the harness's span around each robot's own-keyframe add and search
(`bench.knn_local`) plus the detectors' gossip ingestion
(`tick_phase_ms["knn_ingest"]`), over the traced window."""


def read(ctx):
    spans = ctx.spans or {}
    local = spans.get("bench.knn_local", {}).get("seconds", 0.0)
    ingest_ms = ctx.records.knn_ingest_window_ms
    if not ctx.keyframes or not (local or ingest_ms):
        return None
    return (1e3 * local + ingest_ms) / ctx.keyframes
