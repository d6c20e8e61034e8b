# Convenience targets (parity with the reference's wrapper Makefile role).

.PHONY: test test-gpu smoke bench report native clean

test:
	python -m pytest tests/ -q

# The tests marked `gpu`, compiled on a card; one process for the card.
test-gpu:
	JAX_PLATFORMS=cuda python -m pytest tests/ -q -m gpu -p no:xdist

smoke:
	python chip_smoke.py

bench:
	python bench.py

report:
	python -m ssim_tpu.testing.report

native:
	$(MAKE) -C native

clean:
	$(MAKE) -C native clean
	find . -name __pycache__ -type d -exec rm -rf {} +
