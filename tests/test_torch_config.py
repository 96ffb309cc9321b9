"""The port's config (chitu_tpu_torch/config.py) against the JAX package's:
the same cards, the same YAML reading, the same override trees."""

import dataclasses
import filecmp
import glob
import os

import pytest
import yaml

from chitu_tpu import config as jcfg
from chitu_tpu_torch import config as tcfg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_CARDS = os.path.join(ROOT, "chitu_tpu", "configs")
PORT_CARDS = os.path.join(ROOT, "chitu_tpu_torch", "configs")


def _cards(base):
    return sorted(
        os.path.relpath(p, base)
        for p in glob.glob(os.path.join(base, "**", "*.yaml"), recursive=True)
    )


def test_cards_byte_identical():
    names = _cards(JAX_CARDS)
    assert names and names == _cards(PORT_CARDS)
    for n in names:
        assert filecmp.cmp(
            os.path.join(JAX_CARDS, n), os.path.join(PORT_CARDS, n),
            shallow=False,
        ), n


@pytest.mark.parametrize("card", _cards(PORT_CARDS))
def test_yaml_reader_matches_safe_load(card):
    with open(os.path.join(PORT_CARDS, card)) as f:
        text = f.read()
    assert tcfg.read_yaml(text) == (yaml.safe_load(text) or {})


def test_yaml_reader_scalars_and_nesting():
    text = (
        "# comment\n"
        "a: 1e-05\n"  # YAML 1.1: no dot -> a string
        "b: 1.5e-07  # trailing comment\n"
        "c: 'it''s'\n"
        'd: "x # not a comment"\n'
        "e: ~\n"
        "f: on\n"
        "g:\n"
        "  h: -3\n"
        "  i: .5\n"
    )
    assert tcfg.read_yaml(text) == yaml.safe_load(text)


@pytest.mark.parametrize(
    "overrides",
    [
        [],
        ["models=Llama-3-8B-Instruct", "infer.max_reqs=8", "infer.page_size=64"],
        ["models=DeepSeek-R1", "models.moe.n_routed_experts=16",
         "infer.decode_buckets=[1,2,4]", "scheduler.policy=stride"],
        ["models=glm-4-9b-chat", "infer.hybrid_step=false",
         "request.temperature=0.5", "models.norm_eps=1e-6"],
    ],
)
def test_dotted_overrides_give_equal_trees(overrides):
    want = dataclasses.asdict(jcfg.load_config(overrides=overrides))
    got = dataclasses.asdict(tcfg.load_config(overrides=overrides))
    assert got == want


def test_list_model_cards_equal():
    assert tcfg.list_model_cards() == jcfg.list_model_cards()
