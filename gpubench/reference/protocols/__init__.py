"""The four parsers of ``-msgtype=all`` (scm, scm+, idm, r900), registered
on import, with the registry of ``base.py``."""

from .base import Message, build_decoder_config, digest, new_parser

from . import scm  # noqa: F401
from . import scmplus  # noqa: F401
from . import idm  # noqa: F401
from . import r900  # noqa: F401

__all__ = ["Message", "build_decoder_config", "digest", "new_parser"]
