"""recall_at_10: mean recall@10 of every answered query against the exact
top-10 the reference works out after the window."""


def read(run):
    return run.recall
