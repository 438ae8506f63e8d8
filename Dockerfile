# Container build — reference parity: Dockerfile:1-18 (two-stage Go build
# → slim runtime). Python has no compile stage for the framework itself,
# but the native append-log store does: build it with the full toolchain,
# ship only the shared object + sources into the slim image.
#
# The image runs the CPU backend by default; on NVIDIA GPU hosts install
# the matching jax[cuda12] wheel at deploy time (the CUDA runtime is
# host-coupled, baking it into a generic image pins the wrong one).

FROM python:3.12-slim-bookworm AS build
WORKDIR /app

RUN apt-get update && apt-get install -y --no-install-recommends g++ make \
    && rm -rf /var/lib/apt/lists/*

COPY native/ native/
RUN make -C native

FROM python:3.12-slim-bookworm

WORKDIR /app
RUN pip install --no-cache-dir "jax[cpu]" numpy msgpack pyyaml requests xxhash

COPY semadb_tpu/ semadb_tpu/
COPY config/ config/
COPY --from=build /app/native/build/libsdbkv.so native/build/libsdbkv.so

ENV SEMADB_CONFIG=/app/config/singleServer.yaml
ENV PYTHONPATH=/app

# HTTP API, RPC port (cluster mesh), metrics
EXPOSE 8081 9898 8091

CMD ["python", "-m", "semadb_tpu.main"]
