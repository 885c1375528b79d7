"""The port's one way to read a YAML document.

PyYAML's safe loader, with its scanner and parser in C (``yaml.CSafeLoader``,
libyaml) where the installed PyYAML was built with libyaml, and in pure
Python (``yaml.SafeLoader``) otherwise.  Both share the safe constructor and
resolver, so the same text gives the same objects.  The choice follows what
PyYAML can do, once, at import.
"""

from __future__ import annotations

import sys

import yaml

LOADER = yaml.CSafeLoader if yaml.__with_libyaml__ else yaml.SafeLoader

_PROFILING = "linearham_tpu_torch.utils.profiling"


def load_yaml(stream):
    """The single document of ``stream`` (a str, bytes or an open file), as
    ``yaml.safe_load`` reads it; malformed text raises ``yaml.YAMLError``.

    Counter (``utils.profiling``): ``yaml_libyaml_loads``, or
    ``yaml_python_loads`` under the pure-Python loader, one a document.
    """
    root = yaml.load(stream, Loader=LOADER)
    # A recorder can be active only where the profiling module is loaded;
    # looking it up here keeps torch out of the host-only post-processing
    # mains, which read YAML too.
    profiling = sys.modules.get(_PROFILING)
    if profiling is not None:
        profiling.count("yaml_python_loads" if LOADER is yaml.SafeLoader
                        else "yaml_libyaml_loads")
    return root
