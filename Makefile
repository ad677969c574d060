# Convenience targets. The Python package needs no build step; the native
# tier compiles itself on first use (see ipmzoo/native/native.py).

PY ?= python

.PHONY: test bench native demos web clean

test:
	$(PY) -m pytest tests/ -q

bench:
	$(PY) bench.py

native:
	$(PY) -c "from ipmzoo import native; assert native.available(); print('native tier OK')"

demos:
	JAX_PLATFORMS=cpu JAX_ENABLE_X64=1 $(PY) -m ipmzoo.frontend.cli

web:
	JAX_PLATFORMS=cpu JAX_ENABLE_X64=1 $(PY) -m ipmzoo.frontend.cli --web docs

clean:
	rm -f ipmzoo/native/_linear_solvers.so
	find . -name __pycache__ -type d -exec rm -rf {} +
