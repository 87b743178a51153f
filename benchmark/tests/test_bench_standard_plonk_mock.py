"""The `standard_plonk` circuit through the port's MockProver, and with
one cell of its witness changed."""

from benchmark.circuits import standard_plonk
from halo2_tpu_torch.circuit import Region
from halo2_tpu_torch.dev import MockProver


def test_mock_prover_accepts():
    assert MockProver.run(5, standard_plonk.circuit(5, 1234567),
                          []).verify() == []


def test_mock_prover_rejects_one_changed_cell(monkeypatch):
    real = Region.assign_advice_bulk

    def changed(self, annotation, column, offset, values):
        if annotation == "out":
            values = list(values)
            values[4] += 1
        return real(self, annotation, column, offset, values)

    monkeypatch.setattr(Region, "assign_advice_bulk", changed)
    failures = MockProver.run(5, standard_plonk.circuit(5, 1234567),
                              []).verify()
    assert failures
