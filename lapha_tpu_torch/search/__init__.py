from .value_fn import ValueFunction

__all__ = ["ValueFunction"]
