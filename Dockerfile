# cellregmap-tpu container (CPU JAX; reference parity: the reference's
# Dockerfile).  For an NVIDIA GPU install "jax[cuda12]" instead of "jax[cpu]".
FROM python:3.12-slim

RUN apt-get update && apt-get install -y --no-install-recommends g++ \
    && rm -rf /var/lib/apt/lists/*

WORKDIR /app
COPY pyproject.toml README.md ./
COPY cellregmap_tpu ./cellregmap_tpu
RUN pip install --no-cache-dir "jax[cpu]" scipy numpy tqdm && \
    pip install --no-cache-dir .

CMD ["python", "-c", "import cellregmap_tpu; print(cellregmap_tpu.__version__)"]
