"""The port's registry resolves every name of the JAX package's registry,
and tells a model that is not ported from a ported model whose own import
fails."""

import sys
import types

import pytest

from paddlerec_tpu_torch.core import registry


def test_a_model_without_a_module_is_not_ported():
    with pytest.raises(KeyError, match="'rank.no_such_model' is not ported"):
        registry.get_model_class("rank.no_such_model")
    with pytest.raises(KeyError, match="is not ported"):
        registry.get_model_class("no_such_family.model")


TREE_RL_DEMO = {"treebased.tdm": "treebased.tdm", "rl.a2c": "rl.a2c",
                "demo.movie_recall": "demo.movie_recommand",
                "demo.movie_rank": "demo.movie_recommand"}


@pytest.mark.parametrize("name", sorted(TREE_RL_DEMO))
def test_the_tree_rl_and_demo_names_resolve(name):
    """The last four registrations; the movie demo's two names live in one
    module, as in the JAX package."""
    cls = registry.get_model_class(name)
    assert cls.registry_name == name
    assert cls.__module__ == f"paddlerec_tpu_torch.models.{TREE_RL_DEMO[name]}.model"


def test_every_name_of_the_jax_registry_resolves_in_the_port():
    """``paddlerec_tpu/models/__init__.py``'s list, and every name its
    modules register once all are imported."""
    from paddlerec_tpu.core import registry as jax_registry
    from paddlerec_tpu.models import _BUILTIN, import_all

    import_all()
    assert len(_BUILTIN) == 62
    names = set(_BUILTIN) | set(jax_registry._REGISTRY)
    for name in sorted(names):
        # the same registration (rank.logistic_regression is rank.lr's class
        # in both packages)
        assert (registry.get_model_class(name).registry_name
                == jax_registry.get_model_class(name).registry_name), name


MATCH_SLICE = ("match.dssm", "match.multiview_simnet", "match.match_pyramid", "match.kim",
               "contentunderstanding.tagspace", "contentunderstanding.textcnn",
               "recall.ncf", "recall.word2vec")


@pytest.mark.parametrize("name", MATCH_SLICE)
def test_the_match_content_and_recall_names_resolve(name):
    cls = registry.get_model_class(name)
    assert cls.registry_name == name
    assert cls.__module__ == f"paddlerec_tpu_torch.models.{name}.model"


GRAPH_SLICE = ("recall.deepwalk", "recall.mind", "recall.tisas", "recall.ensfm",
               "recall.mhcn", "graph.gnn", "graph.lightgcn", "graph.transformer_conv",
               "graph.deepwalk_million")


@pytest.mark.parametrize("name", GRAPH_SLICE)
def test_the_recall_and_graph_names_resolve(name):
    """Recall's last five and the graph family; the three yaml names of the
    graph family live in ``graph.gnn``'s module, as in the JAX package."""
    cls = registry.get_model_class(name)
    assert cls.registry_name == name
    owner = "graph.gnn" if name.startswith("graph.") else name
    assert cls.__module__ == f"paddlerec_tpu_torch.models.{owner}.model"


def test_a_broken_import_inside_a_ported_model_is_not_reported_as_a_missing_port(
        tmp_path, monkeypatch):
    # a model module that exists and imports a dependency that does not
    name = "paddlerec_tpu_torch.models.rank.broken_dep.model"
    parent = types.ModuleType("paddlerec_tpu_torch.models.rank.broken_dep")
    parent.__path__ = [str(tmp_path / "broken_dep")]
    (tmp_path / "broken_dep").mkdir()
    (tmp_path / "broken_dep" / "model.py").write_text("import a_dependency_that_is_absent\n")
    monkeypatch.setitem(sys.modules, parent.__name__, parent)
    with pytest.raises(ModuleNotFoundError, match="a_dependency_that_is_absent") as err:
        registry.get_model_class("rank.broken_dep")
    assert not isinstance(err.value, KeyError)
    sys.modules.pop(name, None)
