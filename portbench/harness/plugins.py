"""Modules that a configuration, a traffic mix or a per-layer metric
brings as a file of its own, found by name under the checkout root:
``portbench/reference/<name>.py`` (an architecture's reference),
``portbench/scenes/<name>.py`` (a scene generator) and
``portbench/metrics/<name>.py`` (a reader).  A later change adds such a
file and an entry that names it; no file of the harness is edited."""

import importlib.util
import os
import re

from portbench.reference import model as ref_model

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def load(root, folder, name):
    """The module ``portbench/<folder>/<name>.py`` under ``root``, loaded
    by path; a name that is no file there fails with the path it looked
    for."""
    path = os.path.join(root, "portbench", folder, f"{name}.py")
    if not NAME.match(str(name)) or not os.path.isfile(path):
        raise FileNotFoundError(f"no {folder} module {name!r}: looked for "
                                f"{path}")
    spec = importlib.util.spec_from_file_location(
        re.sub(r"[.-]", "_", f"portbench_{folder}_{name}"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def architecture(conf, root):
    """The reference module of a configuration file (a dict): its
    top-level ``architecture`` under ``portbench/reference/``, and
    :mod:`portbench.reference.model` where it names none or ``model``."""
    name = conf.get("architecture", "model")
    return ref_model if name == "model" else load(root, "reference", name)
