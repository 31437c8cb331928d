"""rounds_read: the rounds a run's readers saw (a metric only this fixture has)."""


def read(run):
    return float(len(run.rounds)) if run.rounds else None
