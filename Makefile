# fennec-tpu development targets (reference Makefile parity)

PY ?= python

.PHONY: test test-unit test-integration fixtures native bench lint clean

test: native
	$(PY) -m pytest tests/ -q

test-unit:
	$(PY) -m pytest tests/ -q -m "not slow"

test-integration:
	$(PY) -m pytest tests/test_integration.py tests/test_cli.py -q

fixtures:
	$(PY) -m pytest tests/test_integration.py -q -k TestFullPipeline --co -q >/dev/null; \
	$(PY) -c "import sys; sys.path.insert(0,'tests'); sys.path.insert(0,'.'); \
import test_integration as t; \
import pathlib; \
[t.gen_if_missing(t.TESTDATA / n, f) for n, f in [ \
  ('gradient.jpg', t.gradient_jpg), ('transparent.png', t.transparent_png), \
  ('fewcolors.png', t.fewcolors_png), ('large_photo.jpg', t.large_photo_jpg), \
  ('grayscale.png', t.grayscale_png)]]"

native:
	$(PY) -m fennec_tpu.native.build

bench:
	$(PY) bench.py

lint:
	$(PY) -m compileall -q fennec_tpu tests bench.py chip_smoke.py __graft_entry__.py

clean:
	rm -rf fennec_tpu/native/_fennec_native.so .pytest_cache
	find . -name __pycache__ -type d -exec rm -rf {} +
