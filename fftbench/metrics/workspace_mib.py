"""The device memory the port takes during the window: the peak allocated
less what was allocated when the window opened (the input pool and the
benchmark's own buffers are in the latter)."""


def read(run):
    if not run.cuda:
        return None
    return run.workspace_bytes / 2**20
