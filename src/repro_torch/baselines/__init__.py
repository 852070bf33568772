from .hellings import hellings_cfpq  # noqa: F401
