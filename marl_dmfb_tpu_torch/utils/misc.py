"""Small utilities (the reference's common/utils.py surface; JAX
``utils/misc.py``)."""

import functools
import inspect


def store_args(method):
    """Store a method's arguments, defaults included, as attributes of its
    instance before it runs (reference common/utils.py:6-30, which its main
    path does not use; kept for the utility surface)."""
    argspec = inspect.getfullargspec(method)
    defaults = {}
    if argspec.defaults is not None:
        defaults = dict(zip(argspec.args[-len(argspec.defaults):],
                            argspec.defaults))
    if argspec.kwonlydefaults is not None:
        defaults.update(argspec.kwonlydefaults)
    arg_names = argspec.args[1:]

    @functools.wraps(method)
    def wrapper(*positional_args, **keyword_args):
        self = positional_args[0]
        args = defaults.copy()
        for name, value in zip(arg_names, positional_args[1:]):
            args[name] = value
        args.update(keyword_args)
        self.__dict__.update(args)
        return method(*positional_args, **keyword_args)

    return wrapper
