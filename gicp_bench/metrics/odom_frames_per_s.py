"""odom_frames_per_s: frames of the LiDAR stream registered and inserted into the map, over the whole measured window (all the window's work
over all its time, host clock)."""


def read(ctx):
    n = ctx.counts.get("frames")
    return None if not n else n / ctx.window_s
