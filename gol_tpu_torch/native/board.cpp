// Native pixel-board visualiser core — the C++ analog of the reference's
// SDL window wrapper (ref: sdl/window.go:22-104: NewWindow, FlipPixel,
// SetPixel, CountPixels, ClearPixels, RenderFrame, PollEvent).
//
// Two modes behind one C API:
//  - headless: an in-memory ARGB8888 framebuffer (the shadow board the
//    reference's -noVis tests keep by hand, ref: sdl_test.go:18-90);
//  - windowed: the same framebuffer presented through libSDL2, loaded at
//    RUNTIME with dlopen so this file builds on machines without SDL2
//    headers. Only the frozen SDL2 ABI surface we need is declared below.
//
// Exposed as a flat C ABI for ctypes (no pybind11 in this image).
//
// Build: g++ -O2 -fPIC -shared -o libgolvis.so board.cpp -ldl

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <dlfcn.h>

// ---- minimal SDL2 ABI (stable since 2.0) ----------------------------------
// Types are opaque pointers; the event is a 56-byte union we index at the
// documented, ABI-frozen offsets (SDL_KeyboardEvent: u32 type; keysym.sym
// is an i32 at byte 20 = type+timestamp+windowID+state/repeat/padding+scancode).
namespace sdl {
constexpr uint32_t INIT_VIDEO = 0x20;
constexpr uint32_t WINDOWPOS_UNDEFINED = 0x1FFF0000u;
constexpr uint32_t PIXELFORMAT_ARGB8888 = 0x16362004u;
constexpr int TEXTUREACCESS_STREAMING = 1;
constexpr uint32_t EV_QUIT = 0x100;
constexpr uint32_t EV_KEYDOWN = 0x300;

using InitFn = int (*)(uint32_t);
using QuitFn = void (*)();
using CreateWindowFn = void* (*)(const char*, int, int, int, int, uint32_t);
using DestroyWindowFn = void (*)(void*);
using CreateRendererFn = void* (*)(void*, int, uint32_t);
using DestroyRendererFn = void (*)(void*);
using CreateTextureFn = void* (*)(void*, uint32_t, int, int, int);
using DestroyTextureFn = void (*)(void*);
using UpdateTextureFn = int (*)(void*, const void*, const void*, int);
using RenderClearFn = int (*)(void*);
using RenderCopyFn = int (*)(void*, void*, const void*, const void*);
using RenderPresentFn = void (*)(void*);
using PollEventFn = int (*)(void*);

struct Api {
  void* lib = nullptr;
  InitFn Init;
  QuitFn Quit;
  CreateWindowFn CreateWindow;
  DestroyWindowFn DestroyWindow;
  CreateRendererFn CreateRenderer;
  DestroyRendererFn DestroyRenderer;
  CreateTextureFn CreateTexture;
  DestroyTextureFn DestroyTexture;
  UpdateTextureFn UpdateTexture;
  RenderClearFn RenderClear;
  RenderCopyFn RenderCopy;
  RenderPresentFn RenderPresent;
  PollEventFn PollEvent;

  bool load() {
    if (lib) return true;
    lib = dlopen("libSDL2-2.0.so.0", RTLD_NOW | RTLD_GLOBAL);
    if (!lib) lib = dlopen("libSDL2.so", RTLD_NOW | RTLD_GLOBAL);
    if (!lib) return false;
    auto sym = [&](const char* n) { return dlsym(lib, n); };
    Init = (InitFn)sym("SDL_Init");
    Quit = (QuitFn)sym("SDL_Quit");
    CreateWindow = (CreateWindowFn)sym("SDL_CreateWindow");
    DestroyWindow = (DestroyWindowFn)sym("SDL_DestroyWindow");
    CreateRenderer = (CreateRendererFn)sym("SDL_CreateRenderer");
    DestroyRenderer = (DestroyRendererFn)sym("SDL_DestroyRenderer");
    CreateTexture = (CreateTextureFn)sym("SDL_CreateTexture");
    DestroyTexture = (DestroyTextureFn)sym("SDL_DestroyTexture");
    UpdateTexture = (UpdateTextureFn)sym("SDL_UpdateTexture");
    RenderClear = (RenderClearFn)sym("SDL_RenderClear");
    RenderCopy = (RenderCopyFn)sym("SDL_RenderCopy");
    RenderPresent = (RenderPresentFn)sym("SDL_RenderPresent");
    PollEvent = (PollEventFn)sym("SDL_PollEvent");
    return Init && CreateWindow && CreateRenderer && CreateTexture &&
           UpdateTexture && RenderClear && RenderCopy && RenderPresent &&
           PollEvent;
  }
};

Api& api() {
  static Api a;
  return a;
}
}  // namespace sdl

// ---- board ----------------------------------------------------------------

struct Board {
  int w = 0, h = 0;
  uint32_t* pixels = nullptr;  // ARGB8888, row-major (ref: sdl/window.go:38-43)
  // SDL objects (null when headless).
  void* win = nullptr;
  void* ren = nullptr;
  void* tex = nullptr;
  bool sdl_inited = false;
};

extern "C" {

// want_window: 0 = headless shadow board, 1 = try SDL (falls back to
// headless when libSDL2 is absent or window creation fails).
Board* golvis_create(int w, int h, int want_window) {
  if (w <= 0 || h <= 0) return nullptr;
  Board* b = new Board;
  b->w = w;
  b->h = h;
  b->pixels = (uint32_t*)std::calloc((size_t)w * h, 4);
  if (!b->pixels) {
    delete b;
    return nullptr;
  }
  if (want_window && sdl::api().load()) {
    auto& s = sdl::api();
    if (s.Init(sdl::INIT_VIDEO) == 0) {
      b->sdl_inited = true;
      b->win = s.CreateWindow("gol_tpu", (int)sdl::WINDOWPOS_UNDEFINED,
                              (int)sdl::WINDOWPOS_UNDEFINED, w, h, 0);
      if (b->win) {
        b->ren = s.CreateRenderer(b->win, -1, 0);
        if (b->ren)
          b->tex = s.CreateTexture(b->ren, sdl::PIXELFORMAT_ARGB8888,
                                   sdl::TEXTUREACCESS_STREAMING, w, h);
      }
    }
  }
  return b;
}

int golvis_has_window(Board* b) { return b && b->tex ? 1 : 0; }

// XOR the pixel — flipping twice restores it (ref: sdl/window.go:78-88).
// Out-of-range coordinates are a hard error in the reference (panic);
// here they return -1 so the caller can raise.
int golvis_flip_pixel(Board* b, int x, int y) {
  if (!b || x < 0 || x >= b->w || y < 0 || y >= b->h) return -1;
  b->pixels[(size_t)y * b->w + x] ^= 0xFFFFFFFFu;
  return 0;
}

int golvis_set_pixel(Board* b, int x, int y, int on) {
  if (!b || x < 0 || x >= b->w || y < 0 || y >= b->h) return -1;
  b->pixels[(size_t)y * b->w + x] = on ? 0xFFFFFFFFu : 0u;
  return 0;
}

int golvis_get_pixel(Board* b, int x, int y) {
  if (!b || x < 0 || x >= b->w || y < 0 || y >= b->h) return -1;
  return b->pixels[(size_t)y * b->w + x] != 0;
}

// Count of lit pixels (ref: sdl/window.go:90-99) — the shadow-board
// alive count the protocol tests assert on (ref: sdl_test.go:66-74).
long golvis_count_pixels(Board* b) {
  if (!b) return -1;
  long n = 0;
  const size_t total = (size_t)b->w * b->h;
  for (size_t i = 0; i < total; ++i) n += b->pixels[i] != 0;
  return n;
}

void golvis_clear(Board* b) {
  if (b) std::memset(b->pixels, 0, (size_t)b->w * b->h * 4);
}

// Bulk load a {0,nonzero} byte mask — one call instead of W*H set_pixel
// round-trips through ctypes (no reference analog; the Go loop flips
// pixel-by-pixel because its events arrive cell-by-cell).
void golvis_load_mask(Board* b, const uint8_t* mask) {
  if (!b || !mask) return;
  const size_t total = (size_t)b->w * b->h;
  for (size_t i = 0; i < total; ++i) b->pixels[i] = mask[i] ? 0xFFFFFFFFu : 0u;
}

// XOR a {0,nonzero} byte mask of flipped cells into the board — the bulk
// analog of a burst of FlipPixel calls.
void golvis_flip_mask(Board* b, const uint8_t* mask) {
  if (!b || !mask) return;
  const size_t total = (size_t)b->w * b->h;
  for (size_t i = 0; i < total; ++i)
    if (mask[i]) b->pixels[i] ^= 0xFFFFFFFFu;
}

// ---- gray-level mode (multi-state Generations rules, r5) ------------------
// A level v in 0..255 renders as the gray ARGB pixel FF·vvvvvv (0 stays
// fully dead/black). The two-state ops above remain valid on the same
// framebuffer: 255 encodes to 0xFFFFFFFF, exactly the lit pixel.

static inline uint32_t encode_level(uint8_t v) {
  return v ? (0xFF000000u | ((uint32_t)v * 0x010101u)) : 0u;
}

// Bulk load a full gray byte grid — golvis_load_mask generalized to levels.
void golvis_load_levels(Board* b, const uint8_t* levels) {
  if (!b || !levels) return;
  const size_t total = (size_t)b->w * b->h;
  for (size_t i = 0; i < total; ++i) b->pixels[i] = encode_level(levels[i]);
}

// Set every masked cell to its grid level — the bulk form of a level
// FlipBatch (levels SET cells; two-state batches XOR them).
void golvis_update_levels(Board* b, const uint8_t* mask,
                          const uint8_t* levels) {
  if (!b || !mask || !levels) return;
  const size_t total = (size_t)b->w * b->h;
  for (size_t i = 0; i < total; ++i)
    if (mask[i]) b->pixels[i] = encode_level(levels[i]);
}

int golvis_set_level(Board* b, int x, int y, int level) {
  if (!b || x < 0 || x >= b->w || y < 0 || y >= b->h) return -1;
  if (level < 0 || level > 255) return -1;
  b->pixels[(size_t)y * b->w + x] = encode_level((uint8_t)level);
  return 0;
}

int golvis_get_level(Board* b, int x, int y) {
  if (!b || x < 0 || x >= b->w || y < 0 || y >= b->h) return -1;
  return (int)(b->pixels[(size_t)y * b->w + x] & 0xFFu);
}

// Two-state toggle on a gray board: nonzero -> dead, dead -> alive
// (full level). The raw ARGB XOR of golvis_flip_mask would turn grays
// into invalid encodings; this keeps every pixel a valid level.
void golvis_toggle_mask(Board* b, const uint8_t* mask) {
  if (!b || !mask) return;
  const size_t total = (size_t)b->w * b->h;
  for (size_t i = 0; i < total; ++i)
    if (mask[i]) b->pixels[i] = b->pixels[i] ? 0u : encode_level(255);
}

// Count of cells at exactly this gray level (255 = the alive count the
// protocol tests assert; dying levels give the per-level histogram).
long golvis_count_level(Board* b, int level) {
  if (!b || level < 0 || level > 255) return -1;
  const uint32_t want = encode_level((uint8_t)level);
  long n = 0;
  const size_t total = (size_t)b->w * b->h;
  for (size_t i = 0; i < total; ++i) n += b->pixels[i] == want;
  return n;
}

// Present the framebuffer (ref: sdl/window.go:56-64). No-op headless.
void golvis_render(Board* b) {
  if (!b || !b->tex) return;
  auto& s = sdl::api();
  s.UpdateTexture(b->tex, nullptr, b->pixels, b->w * 4);
  s.RenderClear(b->ren);
  s.RenderCopy(b->ren, b->tex, nullptr, nullptr);
  s.RenderPresent(b->ren);
}

// Next pending keydown as its SDL keycode (ASCII for letter keys), 0 if
// none, -1 on window close (ref: sdl/loop.go:14-28 maps keysyms to runes).
int golvis_poll_key(Board* b) {
  if (!b || !b->tex) return 0;
  auto& s = sdl::api();
  alignas(8) uint8_t ev[64];
  while (s.PollEvent(ev)) {
    uint32_t type;
    std::memcpy(&type, ev, 4);
    if (type == sdl::EV_QUIT) return -1;
    if (type == sdl::EV_KEYDOWN) {
      int32_t sym;
      std::memcpy(&sym, ev + 20, 4);  // keysym.sym, ABI-frozen offset
      return sym;
    }
  }
  return 0;
}

void golvis_destroy(Board* b) {
  if (!b) return;
  auto& s = sdl::api();
  if (b->tex) s.DestroyTexture(b->tex);
  if (b->ren) s.DestroyRenderer(b->ren);
  if (b->win) s.DestroyWindow(b->win);
  if (b->sdl_inited) s.Quit();
  std::free(b->pixels);
  delete b;
}

}  // extern "C"
