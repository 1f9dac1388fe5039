// C-ABI streaming speech API — the DeepSpeech native-client surface.
//
// Role model: `native_client/deepspeech.h:107-358` (DS_CreateModel /
// DS_CreateStream / DS_FeedAudioContent / DS_IntermediateDecode /
// DS_FinishStream): an embeddable C API that owns per-stream buffering and
// chunking while the acoustic model runs elsewhere. The split: the
// Python process keeps the compute (streaming LSTM + decoder) and registers it
// as a vtable of C callbacks; this layer owns the session state machine —
// frame accumulation, fixed-size chunk dispatch, logit history, text
// assembly — so any C host can drive a stream with four calls.
//
// All functions return 0 on success, negative on error. Thread-safety: one
// stream may be driven from one thread at a time; distinct streams are
// independent (per-stream mutex guards against accidental sharing).

#include <cstdint>
#include <cstring>
#include <mutex>
#include <new>
#include <vector>

extern "C" {

enum {
  SP_OK = 0,
  SP_ERR_ARG = -1,
  SP_ERR_CALLBACK = -2,
  SP_ERR_STATE = -3,
  SP_ERR_CAP = -4,
};

// Embedder vtable. model_ctx identifies the model; stream_ctx carries the
// recurrent state (LSTM carry) between chunks of one stream.
typedef void* (*sp_stream_init_fn)(void* model_ctx);
typedef void (*sp_stream_free_fn)(void* model_ctx, void* stream_ctx);
// Consume n_frames feature frames, append logits for every frame whose
// context is complete. Returns emitted frame count via out_frames (may be
// fewer than n_frames while the context window fills). out_logits capacity
// is n_frames + lookahead rows of `vocab` floats.
typedef int (*sp_infer_fn)(void* model_ctx, void* stream_ctx,
                           const float* frames, int32_t n_frames,
                           float* out_logits, int32_t* out_frames);
// End-of-stream: flush lookahead frames still inside the recurrent state.
typedef int (*sp_flush_fn)(void* model_ctx, void* stream_ctx,
                           float* out_logits, int32_t* out_frames);
// Decode accumulated logits [n_frames, vocab] to UTF-8 text.
typedef int (*sp_decode_fn)(void* model_ctx, const float* logits,
                            int32_t n_frames, char* out, int32_t cap);

struct SpModel {
  int32_t n_feat;
  int32_t vocab;
  int32_t chunk_frames;   // dispatch granularity to the accelerator
  int32_t lookahead;      // max extra frames a flush can emit
  sp_stream_init_fn stream_init;
  sp_stream_free_fn stream_free;
  sp_infer_fn infer;
  sp_flush_fn flush;
  sp_decode_fn decode;
  void* ctx;
};

struct SpStream {
  SpModel* model;
  void* stream_ctx;
  std::vector<float> pending;   // buffered frames not yet dispatched
  std::vector<float> logits;    // accumulated [n_emitted, vocab]
  int32_t n_emitted;
  bool finished;
  std::mutex mu;
};

void* sp_create_model(int32_t n_feat, int32_t vocab, int32_t chunk_frames,
                      int32_t lookahead, sp_stream_init_fn stream_init,
                      sp_stream_free_fn stream_free, sp_infer_fn infer,
                      sp_flush_fn flush, sp_decode_fn decode, void* ctx) {
  if (n_feat <= 0 || vocab <= 0 || chunk_frames <= 0 || !infer || !decode)
    return nullptr;
  SpModel* m = new (std::nothrow) SpModel{n_feat, vocab, chunk_frames,
                                          lookahead < 0 ? 0 : lookahead,
                                          stream_init, stream_free,
                                          infer, flush, decode, ctx};
  return m;
}

void sp_free_model(void* vm) { delete static_cast<SpModel*>(vm); }

void* sp_create_stream(void* vm) {
  SpModel* m = static_cast<SpModel*>(vm);
  if (!m) return nullptr;
  SpStream* s = new (std::nothrow) SpStream();
  if (!s) return nullptr;
  s->model = m;
  s->stream_ctx = m->stream_init ? m->stream_init(m->ctx) : nullptr;
  s->n_emitted = 0;
  s->finished = false;
  return s;
}

void sp_free_stream(void* vs) {
  SpStream* s = static_cast<SpStream*>(vs);
  if (!s) return;
  if (s->model->stream_free)
    s->model->stream_free(s->model->ctx, s->stream_ctx);
  delete s;
}

// Dispatch every full chunk in `pending` through the infer callback.
static int drain_chunks(SpStream* s) {
  SpModel* m = s->model;
  const int32_t chunk = m->chunk_frames;
  std::vector<float> out((chunk + m->lookahead) * m->vocab);
  while ((int32_t)(s->pending.size() / m->n_feat) >= chunk) {
    int32_t emitted = 0;
    int rc = m->infer(m->ctx, s->stream_ctx, s->pending.data(), chunk,
                      out.data(), &emitted);
    if (rc != 0) return SP_ERR_CALLBACK;
    if (emitted < 0 || emitted > chunk + m->lookahead) return SP_ERR_CALLBACK;
    s->logits.insert(s->logits.end(), out.begin(),
                     out.begin() + (size_t)emitted * m->vocab);
    s->n_emitted += emitted;
    s->pending.erase(s->pending.begin(),
                     s->pending.begin() + (size_t)chunk * m->n_feat);
  }
  return SP_OK;
}

int sp_feed(void* vs, const float* frames, int32_t n_frames) {
  SpStream* s = static_cast<SpStream*>(vs);
  if (!s || (!frames && n_frames > 0) || n_frames < 0) return SP_ERR_ARG;
  std::lock_guard<std::mutex> g(s->mu);
  if (s->finished) return SP_ERR_STATE;
  s->pending.insert(s->pending.end(), frames,
                    frames + (size_t)n_frames * s->model->n_feat);
  return drain_chunks(s);
}

static int decode_locked(SpStream* s, char* out, int32_t cap) {
  if (cap <= 0 || !out) return SP_ERR_ARG;
  out[0] = '\0';
  if (s->n_emitted == 0) return SP_OK;
  return s->model->decode(s->model->ctx, s->logits.data(), s->n_emitted,
                          out, cap) == 0 ? SP_OK : SP_ERR_CALLBACK;
}

int sp_intermediate(void* vs, char* out, int32_t cap) {
  SpStream* s = static_cast<SpStream*>(vs);
  if (!s) return SP_ERR_ARG;
  std::lock_guard<std::mutex> g(s->mu);
  return decode_locked(s, out, cap);
}

int sp_finish(void* vs, char* out, int32_t cap) {
  SpStream* s = static_cast<SpStream*>(vs);
  if (!s) return SP_ERR_ARG;
  std::lock_guard<std::mutex> g(s->mu);
  if (s->finished) return SP_ERR_STATE;
  SpModel* m = s->model;
  // trailing partial chunk: dispatch as a short final window
  int32_t tail = (int32_t)(s->pending.size() / m->n_feat);
  if (tail > 0) {
    std::vector<float> outv((tail + m->lookahead) * m->vocab);
    int32_t emitted = 0;
    int rc = m->infer(m->ctx, s->stream_ctx, s->pending.data(), tail,
                      outv.data(), &emitted);
    if (rc != 0 || emitted < 0 || emitted > tail + m->lookahead)
      return SP_ERR_CALLBACK;
    s->logits.insert(s->logits.end(), outv.begin(),
                     outv.begin() + (size_t)emitted * m->vocab);
    s->n_emitted += emitted;
    s->pending.clear();
  }
  if (m->flush) {
    std::vector<float> outv((m->lookahead + 1) * m->vocab);
    int32_t emitted = 0;
    int rc = m->flush(m->ctx, s->stream_ctx, outv.data(), &emitted);
    if (rc != 0 || emitted < 0 || emitted > m->lookahead)
      return SP_ERR_CALLBACK;
    s->logits.insert(s->logits.end(), outv.begin(),
                     outv.begin() + (size_t)emitted * m->vocab);
    s->n_emitted += emitted;
  }
  s->finished = true;
  return decode_locked(s, out, cap);
}

int32_t sp_stream_frames_emitted(void* vs) {
  SpStream* s = static_cast<SpStream*>(vs);
  if (!s) return SP_ERR_ARG;
  std::lock_guard<std::mutex> g(s->mu);
  return s->n_emitted;
}

}  // extern "C"
