# Development targets (parity with the reference's Makefile: lint + tests).

.PHONY: tests tests-all coverage lint native bench clean

# Fast tier: excludes tests auto-marked `slow` in tests/conftest.py
# (dw-refinement end-to-end runs, large halo sweeps).  < ~4 min serial.
tests:
	python -m pytest tests -q -m "not slow"

# Everything, sharded across workers (serial full run exceeds 25 min).
tests-all:
	python -m pytest tests -q -n 8

# Branch coverage on the fast tier (reference parity: pyproject.toml:38-39
# runs coverage on every test invocation).  Needs pytest-cov (an extra —
# `pip install arnoldi-jax[coverage]`); config in [tool.coverage.*].
coverage:
	@python -c "import pytest_cov" 2>/dev/null \
	  || { echo "pytest-cov not installed (pip install -e .[coverage])"; exit 1; }
	python -m pytest tests -q -m "not slow" --cov --cov-branch --cov-report=term

lint:
	-ruff check arnoldi_jax tests bench.py __graft_entry__.py

native:
	python -c "from arnoldi_jax.native import dense_tier as d; assert d.available(); print('native dense tier built:', d._LIB_PATH)"

bench:
	python bench.py

clean:
	rm -rf build *.egg-info arnoldi_jax/native/libdense_tier.so
	find . -name __pycache__ -type d -exec rm -rf {} +
