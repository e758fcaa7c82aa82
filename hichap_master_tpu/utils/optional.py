"""Optional dependencies, imported only where a feature needs them."""


def require_matplotlib() -> None:
    """Import matplotlib for the ``--plot`` PDFs (headless backend), with a
    clear error where it is not installed: nothing else needs it."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError(
            "--plot needs matplotlib, which is not installed "
            "(pip install matplotlib); the calls themselves do not") from e
    matplotlib.use("Agg")
