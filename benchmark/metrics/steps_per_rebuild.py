"""Steps of the whole window over the replays of the rebuild unit in it
(``graph_stats()``: ``rebuild_post`` on one card, ``rebuild`` on ranks)."""


def read(ctx):
    if not ctx["rebuilds"]:
        return None
    return ctx["steps"] / ctx["rebuilds"]
