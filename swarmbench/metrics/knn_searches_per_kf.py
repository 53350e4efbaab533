"""knn_searches_per_kf: descriptor searches per keyframe taken in the
traced window, the count of the port's `knn_search` spans
(matching/descriptor_db.py, one per search) over the keyframes."""


def read(ctx):
    n = (ctx.spans or {}).get("knn_search", {}).get("count", 0)
    if not n or not ctx.keyframes:
        return None
    return n / ctx.keyframes
