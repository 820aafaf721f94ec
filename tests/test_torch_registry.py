"""The port's registry tells a model that is not ported from a ported model
whose own import fails."""

import sys
import types

import pytest

from paddlerec_tpu_torch.core import registry


def test_a_model_without_a_module_is_not_ported():
    with pytest.raises(KeyError, match="'rank.no_such_model' is not ported"):
        registry.get_model_class("rank.no_such_model")
    with pytest.raises(KeyError, match="is not ported"):
        registry.get_model_class("no_such_family.model")
    # a family with ported models: its other models are still not ported
    with pytest.raises(KeyError, match="'recall.mind' is not ported"):
        registry.get_model_class("recall.mind")


MATCH_SLICE = ("match.dssm", "match.multiview_simnet", "match.match_pyramid", "match.kim",
               "contentunderstanding.tagspace", "contentunderstanding.textcnn",
               "recall.ncf", "recall.word2vec")


@pytest.mark.parametrize("name", MATCH_SLICE)
def test_the_match_content_and_recall_names_resolve(name):
    cls = registry.get_model_class(name)
    assert cls.registry_name == name
    assert cls.__module__ == f"paddlerec_tpu_torch.models.{name}.model"


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
