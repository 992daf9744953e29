"""Reading the argparse defaults of the JAX package's scripts, for the
tests that hold the port's runners to them (not a test module)."""

import ast
import os

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def script_defaults(rel: str) -> dict:
    """{flag: default} of every ``add_argument`` call in the script at
    ``rel`` (from the repository root), read from its source: a
    ``store_true`` flag without a default is False, any other None."""
    with open(os.path.join(REPO, rel)) as f:
        tree = ast.parse(f.read())
    ref = {}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
                == "add_argument"):
            kw = {k.arg: k.value for k in node.keywords}
            if "default" in kw:
                ref[node.args[0].value] = ast.literal_eval(kw["default"])
            else:
                store_true = ("action" in kw and ast.literal_eval(
                    kw["action"]) == "store_true")
                ref[node.args[0].value] = False if store_true else None
    return ref


def parser_defaults(parser) -> dict:
    """{first option string: default} of an argparse parser's flags."""
    return {a.option_strings[0]: a.default for a in parser._actions
            if a.option_strings}
