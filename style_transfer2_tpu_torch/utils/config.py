"""Layered INI configuration (style_transfer2_tpu/utils/config.py; reference
utils.py:110-127): config.ini, then config_non_git.ini, then an optional
config file named on the command line, later wins, all keys in one
[DEFAULT] section, plus a counting --debug/-d flag that adds to the
config's debug key.
"""

import argparse
import configparser
from pathlib import Path

# The repo root (two levels up from this file's package).
ROOT_DIR = Path(__file__).resolve().parents[2]
CONFIG_PATH = ROOT_DIR / 'config.ini'
CONFIG_PATH_NON_GIT = ROOT_DIR / 'config_non_git.ini'


def parse_args(desc='', argv=None):
    """Parses the standard command line: one optional positional config
    path and a counting debug flag."""
    parser = argparse.ArgumentParser(description=desc)
    parser.add_argument('config', nargs='?', help='the config file')
    parser.add_argument('--debug', '-d', action='count', help='debug')
    args = parser.parse_args(argv)
    if not args.debug:
        args.debug = 0
    return args


def read_config(args=None):
    """The merged [DEFAULT] section of the layered config files. args may
    be the namespace from parse_args() or None."""
    cp = configparser.ConfigParser()
    configs = [str(CONFIG_PATH), str(CONFIG_PATH_NON_GIT)]
    if args is not None and getattr(args, 'config', None):
        configs.append(args.config)
    cp.read(configs)
    return cp['DEFAULT']


def debug_level(args, config):
    """The combined debug level: the command line's --debug count plus the
    config's debug key (reference app.py:393-395)."""
    level = config.getint('debug', 0)
    if args is not None:
        level += getattr(args, 'debug', 0)
    return level
