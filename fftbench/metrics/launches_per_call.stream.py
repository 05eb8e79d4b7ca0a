"""The port's kernel launches in the window (`registry.launch_counts()`,
after less before) over its calls: an exact count."""


def read(run):
    calls = run.requests * run.calls_per_request
    if not calls:
        return None
    return sum(run.launches.values()) / calls
