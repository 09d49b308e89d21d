"""matplotlib for the port's figures, imported at first use: a Python
without matplotlib still runs every sweep, statistic and table."""


def pyplot(what: str):
    """matplotlib's pyplot on the Agg backend. A Python without matplotlib
    raises an ImportError that says which figure needed it."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError(f"{what} needs matplotlib, which is not "
                          f"installed ({e})") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt
